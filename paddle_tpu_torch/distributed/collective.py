"""Process groups and the collective API on ``torch.distributed`` (the
counterpart of ``paddle_tpu/distributed/collective.py``).

The JAX package is one controller over a device mesh: its eager
collectives take a rank-major array, whose row ``i`` is rank ``i``'s
value.  The port runs one process per rank, as Paddle's own runtime does,
so each rank passes its own tensor and gets its own result: rank ``i``'s
result here is row ``i`` of the JAX package's.  Ranks are global ranks
(``src``, ``dst``, ``peer`` and a group's ``ranks``), as in Paddle.

Every collective takes Paddle's ``sync_op`` and returns a :class:`Task`:
with ``sync_op=True`` the operation is issued synchronously (on the card,
ordered with the current stream, so it records into a CUDA graph) and
the task is done; with ``sync_op=False`` it runs asynchronously and
``task.wait()`` orders its result with the current stream.  Collectives
that hand back a new tensor (``all_gather``'s tensor form,
``alltoall_single`` without an output, ``reduce_scatter`` without a
list) return that tensor instead.

``ReduceOp.AVG`` is the backend's average on NCCL; gloo has none, so
there it is a sum divided by the group's size.  Gloo carries CUDA
tensors for ``all_reduce``, ``broadcast`` and ``all_gather``, but its
point-to-point path hands a device pointer to the host's socket (a send
of a CUDA tensor fails with "writev ... Bad address" on the card, and
breaks the pair); so on a gloo group the point-to-point operations,
``reduce_scatter`` and ``alltoall_single`` carry CUDA tensors through
host copies, always (:func:`host_staged`): a transport, not a fallback.
``reduce`` leaves the
tensors of the ranks other than ``dst`` as they were (the JAX package's
semantics; the backends may write them).  Groups, and every collective,
need a process group: before ``init_parallel_env`` they raise.

Telemetry (:mod:`..observability`, while it is on): each call of a
collective books ``pt_collective_ops_total{op}`` and its input bytes
(``pt_collective_bytes_total``, ``pt_collective_bytes``, from shapes and
dtypes: no sync), and the host's wall time around the call
(``pt_collective_time_seconds``).  A call made while a CUDA graph
records on the current stream counts once, at the recording, and books
no time (the JAX package counts once a trace and times only eager
calls); a replay runs no Python and books nothing.  ``isend`` / ``irecv``
and :func:`batch_isend_irecv`'s operations count as ``send`` / ``recv``,
as the JAX package's aliases do; the object collectives are not counted.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from ..observability.telemetry import get_telemetry
from .env import get_rank, get_world_size

__all__ = [
    "ReduceOp", "Group", "Task", "new_group", "get_group",
    "destroy_process_group", "is_initialized", "is_available",
    "get_backend", "all_reduce", "all_gather", "gather",
    "all_gather_object", "broadcast", "broadcast_object_list", "reduce",
    "scatter", "scatter_object_list", "alltoall", "alltoall_single",
    "all_to_all", "reduce_scatter", "send", "recv", "isend", "irecv",
    "barrier", "P2POp", "batch_isend_irecv", "wait", "host_staged",
]


class ReduceOp:
    """Paddle's reduce operations."""
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT}


class Group:
    """A group of global ranks: ``rank`` is this process's index in
    ``ranks`` (-1 when it is not a member), ``process_group`` the
    ``torch.distributed`` group its collectives run on."""

    def __init__(self, rank: int, ranks, id: int, process_group,
                 name: Optional[str] = None):
        self._rank = rank
        self.ranks = list(ranks)
        self.id = id
        self._pg = process_group
        self._name = name
        self.axis_name: Optional[str] = None

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    world_size = nranks

    @property
    def process_group(self):
        return self._pg

    @property
    def name(self) -> str:
        return self._name or f"_default_pg{self.id}"

    @property
    def backend(self) -> str:
        """``"nccl"`` or ``"gloo"``."""
        return str(dist.get_backend(self._pg)).lower()

    def is_member(self) -> bool:
        return self._rank >= 0

    def get_group_rank(self, global_rank: int) -> int:
        return self.ranks.index(global_rank) if global_rank in self.ranks \
            else -1

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks}, backend={self.backend})"


class Task:
    """A collective's handle (Paddle's task): :meth:`wait` orders its
    result with the current stream and runs what must follow it (the
    divide of an average, a copy back)."""

    def __init__(self, work=None, then: Optional[Callable[[], None]] = None):
        self._work, self._then = work, then
        self._keep = None          # a buffer the operation still reads

    def wait(self) -> bool:
        if self._work is not None:
            self._work.wait()
            self._work = None
        if self._then is not None:
            then, self._then = self._then, None
            then()
        return True

    def is_completed(self) -> bool:
        return self._work is None or self._work.is_completed()

    def synchronize(self) -> None:
        self.wait()


_GROUPS: Dict[int, Group] = {}


def is_available() -> bool:
    return dist.is_available()


def is_initialized() -> bool:
    """True once a process group exists (``init_parallel_env``)."""
    return dist.is_available() and dist.is_initialized()


def _require_process_group() -> None:
    if not is_initialized():
        raise RuntimeError("no process group: call init_parallel_env() "
                           "first")


def _default_group() -> Group:
    if 0 not in _GROUPS:
        _require_process_group()
        _GROUPS[0] = Group(dist.get_rank(), range(dist.get_world_size()),
                           id=0, process_group=dist.group.WORLD)
    return _GROUPS[0]


def get_group(id: int = 0) -> Group:
    if id == 0:
        return _default_group()
    return _GROUPS[id]


def new_group(ranks=None, backend=None, timeout=None,
              axis_name=None) -> Group:
    """A group of the global ``ranks`` (all by default).  Every rank must
    call it, for every group, in the same order, as
    ``torch.distributed.new_group`` requires.  ``axis_name`` names the
    mesh axis the group runs along (the JAX package's shard_map axis;
    here only a label, :attr:`Group.axis_name`)."""
    _require_process_group()
    if ranks is None:
        ranks = list(range(get_world_size()))
    ranks = [int(r) for r in ranks]
    gid = max(_GROUPS, default=0) + 1
    me = get_rank()
    kw = {} if timeout is None else {"timeout": timeout}
    pg = dist.new_group(ranks, backend=backend, **kw)
    g = Group(ranks.index(me) if me in ranks else -1, ranks, id=gid,
              process_group=pg)
    g.axis_name = axis_name
    _GROUPS[gid] = g
    return g


def destroy_process_group(group: Optional[Group] = None) -> None:
    """Destroy ``group``, or every group and the world's process group."""
    if group is None or group.id == 0:
        _GROUPS.clear()
        if is_initialized():
            dist.destroy_process_group()
        return
    _GROUPS.pop(group.id, None)
    if is_initialized():
        dist.destroy_process_group(group.process_group)


def get_backend(group: Optional[Group] = None) -> str:
    return _group_of(group).backend


def _group_of(group) -> Group:
    return group if isinstance(group, Group) else _default_group()


def _pg(group) -> object:
    """The ``torch.distributed`` group of ``group`` (the world's for
    None); raises for a rank outside it."""
    g = _group_of(group)
    if not g.is_member():
        raise RuntimeError(f"rank {get_rank()} is not a member of {g}")
    return g.process_group


def _issue(fn, *args, sync_op: bool, then=None, **kwargs) -> Task:
    """``fn(*args, async_op=not sync_op, **kwargs)`` as a :class:`Task`
    (waited, and ``then`` run, when ``sync_op``)."""
    work = fn(*args, async_op=not sync_op, **kwargs)
    task = Task(work, then)
    if sync_op:
        task.wait()
    return task


def _torch_op(op: int, group) -> tuple:
    """(the backend's reduce op, a divide to run after it or None)."""
    if op != ReduceOp.AVG:
        return _TORCH_OP[op], None
    g = _group_of(group)
    if g.backend == "nccl":
        return dist.ReduceOp.AVG, None
    return dist.ReduceOp.SUM, g.nranks


def host_staged(group, tensor) -> bool:
    """Whether ``tensor`` crosses ``group`` through a host copy: a CUDA
    tensor on a gloo group, for the operations gloo cannot take from the
    card (point to point, ``reduce_scatter`` and ``alltoall_single``, which
    ``alltoall``'s tensor form calls)."""
    return bool(getattr(tensor, "is_cuda", False)) and \
        _group_of(group).backend == "gloo"


def _to_host(tensor: torch.Tensor) -> torch.Tensor:
    return tensor.detach().to("cpu").contiguous()


def _copy_back(dst: torch.Tensor, src: torch.Tensor) -> Callable[[], None]:
    def run():
        dst.copy_(src)
    return run


def _then(*fns) -> Callable[[], None]:
    def run():
        for f in fns:
            if f is not None:
                f()
    return run


def _divide(tensor: torch.Tensor, n: Optional[int]) -> Callable[[], None]:
    def run():
        if n is None:
            return
        if tensor.is_floating_point() or tensor.is_complex():
            tensor.div_(n)
        else:
            tensor.copy_(torch.div(tensor, n, rounding_mode="trunc"))
    return run


# -- telemetry ------------------------------------------------------------------

def _capturing() -> bool:
    """Whether a CUDA graph records on the current stream (never
    initialises CUDA)."""
    return torch.cuda.is_available() and torch.cuda.is_initialized() and \
        torch.cuda.is_current_stream_capturing()


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _observe(op: str, nbytes: int) -> None:
    """One call of ``op`` with ``nbytes`` input bytes."""
    tel = get_telemetry()
    if tel.enabled:
        tel.collective_op(op, nbytes)


def _timed(op: str):
    """The host's wall time around the whole public call, outside a graph
    recording."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            tel = get_telemetry()
            if not tel.enabled or _capturing():
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                tel.collective_time(op, time.perf_counter() - t0)
        return wrapper
    return deco


# -- collectives -----------------------------------------------------------------

@_timed("all_reduce")
def all_reduce(tensor: torch.Tensor, op: int = ReduceOp.SUM, group=None,
               sync_op: bool = True) -> Task:
    """Reduce ``tensor`` over the group, in place on every rank."""
    pg = _pg(group)
    _observe("all_reduce", _nbytes(tensor))
    top, n = _torch_op(op, group)
    return _issue(dist.all_reduce, tensor, op=top, group=pg, sync_op=sync_op,
                  then=_divide(tensor, n))


@_timed("all_gather")
def all_gather(tensor_or_list, tensor: Optional[torch.Tensor] = None,
               group=None, sync_op: bool = True, axis: int = 0):
    """``all_gather(tensor_list, tensor)`` fills ``tensor_list`` with each
    rank's ``tensor`` in group order and returns a :class:`Task`;
    ``all_gather(tensor)`` returns the ranks' tensors concatenated on
    ``axis`` (synchronous only)."""
    pg = _pg(group)
    g = _group_of(group)
    _observe("all_gather", _nbytes(tensor if isinstance(tensor_or_list, list)
                                   else tensor_or_list))
    if isinstance(tensor_or_list, list):
        outs = [torch.empty_like(tensor) for _ in range(g.nranks)]
        task = _issue(dist.all_gather, outs, tensor.contiguous(), group=pg,
                      sync_op=sync_op)
        tensor_or_list.clear()
        tensor_or_list.extend(outs)
        return task
    if not sync_op:
        raise ValueError("all_gather's tensor form is synchronous; pass a "
                         "list for sync_op=False")
    src = tensor_or_list.contiguous()
    outs = [torch.empty_like(src) for _ in range(g.nranks)]
    dist.all_gather(outs, src, group=pg)
    return torch.cat(outs, dim=axis)


@_timed("gather")
def gather(tensor: torch.Tensor, gather_list: Optional[list] = None,
           dst: int = 0, group=None, sync_op: bool = True) -> list:
    """Every rank's ``tensor`` into ``gather_list`` on ``dst``, in group
    order; the other ranks' lists are left empty.  Returns the list."""
    pg = _pg(group)
    g = _group_of(group)
    _check_in(g, dst, "gather dst")
    _observe("gather", _nbytes(tensor))
    gather_list = [] if gather_list is None else gather_list
    mine = get_rank() == dst
    outs = [torch.empty_like(tensor) for _ in range(g.nranks)] if mine \
        else None
    _issue(dist.gather, tensor.contiguous(), outs, dst=dst, group=pg,
           sync_op=True)
    gather_list.clear()
    if mine:
        gather_list.extend(outs)
    return gather_list


def all_gather_object(object_list: list, obj, group=None) -> list:
    """Every rank's picklable ``obj`` into ``object_list``, group order."""
    g = _group_of(group)
    out = [None] * g.nranks
    dist.all_gather_object(out, obj, group=_pg(group))
    object_list.clear()
    object_list.extend(out)
    return object_list


def _check_in(g: Group, rank: int, what: str) -> None:
    if rank not in g.ranks:
        raise ValueError(f"{what}={rank} is not in group {g.ranks}")


@_timed("broadcast")
def broadcast(tensor: torch.Tensor, src: int = 0, group=None,
              sync_op: bool = True) -> Task:
    """``src``'s ``tensor`` into every rank's, in place."""
    g = _group_of(group)
    _check_in(g, src, "broadcast src")
    _observe("broadcast", _nbytes(tensor))
    return _issue(dist.broadcast, tensor, src=src, group=_pg(group),
                  sync_op=sync_op)


def broadcast_object_list(object_list: list, src: int = 0,
                          group=None) -> list:
    """``src``'s picklable objects into every rank's ``object_list``."""
    g = _group_of(group)
    _check_in(g, src, "broadcast src")
    dist.broadcast_object_list(object_list, src=src, group=_pg(group))
    return object_list


@_timed("reduce")
def reduce(tensor: torch.Tensor, dst: int = 0, op: int = ReduceOp.SUM,
           group=None, sync_op: bool = True) -> Task:
    """The group's reduction into ``dst``'s ``tensor``; the other ranks'
    tensors keep their values."""
    g = _group_of(group)
    _check_in(g, dst, "reduce dst")
    _observe("reduce", _nbytes(tensor))
    top, n = _torch_op(op, group)
    mine = get_rank() == dst
    work = tensor if mine else tensor.clone()
    return _issue(dist.reduce, work, dst=dst, op=top, group=_pg(group),
                  sync_op=sync_op, then=_divide(tensor, n if mine else None))


@_timed("scatter")
def scatter(tensor: torch.Tensor, tensor_list: Optional[list] = None,
            src: int = 0, group=None, sync_op: bool = True) -> Task:
    """Element ``i`` of ``src``'s ``tensor_list`` into the ``tensor`` of
    the group's ``i``-th rank (booked as the list's bytes on ``src``,
    ``tensor``'s elsewhere)."""
    g = _group_of(group)
    _check_in(g, src, "scatter src")
    items = None
    if get_rank() == src:
        if tensor_list is None or len(tensor_list) != g.nranks:
            raise ValueError(f"scatter's src needs a list of {g.nranks} "
                             f"tensors")
        items = [t.contiguous() for t in tensor_list]
    _observe("scatter", _nbytes(*items) if items else _nbytes(tensor))
    return _issue(dist.scatter, tensor, items, src=src, group=_pg(group),
                  sync_op=sync_op)


def scatter_object_list(out_object_list: list, in_object_list=None,
                        src: int = 0, group=None) -> list:
    """Element ``i`` of ``src``'s ``in_object_list`` as the one element of
    the ``i``-th rank's ``out_object_list``."""
    g = _group_of(group)
    _check_in(g, src, "scatter src")
    out = [None]
    dist.scatter_object_list(out, in_object_list if get_rank() == src
                             else None, src=src, group=_pg(group))
    out_object_list.clear()
    out_object_list.extend(out)
    return out_object_list


@_timed("alltoall")
def alltoall(out_tensor_list, in_tensor_list: Optional[list] = None,
             group=None, sync_op: bool = True):
    """``alltoall(out_list, in_list)``: element ``j`` of this rank's
    ``in_list`` goes to the group's ``j``-th rank, and element ``j`` of
    ``out_list`` is what that rank sent here; returns a :class:`Task`.
    ``alltoall(x)``: the same over ``x``'s first axis (one slot a rank),
    returning the received tensor."""
    pg = _pg(group)
    g = _group_of(group)
    if in_tensor_list is None and not isinstance(out_tensor_list, list):
        x = out_tensor_list
        if x.shape[0] != g.nranks:
            raise ValueError(f"alltoall's tensor form wants {g.nranks} slots "
                             f"on axis 0, got {tuple(x.shape)}")
        _observe("alltoall", _nbytes(x))
        return _alltoall_single(x, group=group)
    ins = [t.contiguous() for t in in_tensor_list]
    _observe("alltoall", _nbytes(*ins))
    outs = [torch.empty_like(t) for t in ins]
    task = _issue(dist.all_to_all, outs, ins, group=pg, sync_op=sync_op)
    out_tensor_list.clear()
    out_tensor_list.extend(outs)
    return task


all_to_all = alltoall


@_timed("alltoall_single")
def alltoall_single(in_tensor: torch.Tensor,
                    out_tensor: Optional[torch.Tensor] = None,
                    in_split_sizes=None, out_split_sizes=None, group=None,
                    sync_op: bool = True):
    """``in_tensor``'s first axis split among the ranks (evenly, or by
    ``in_split_sizes``), each rank's pieces concatenated in group order.
    Into ``out_tensor`` (returns a :class:`Task`), or a new tensor of
    ``in_tensor``'s shape with even splits (returned)."""
    _observe("alltoall_single", _nbytes(in_tensor))
    return _alltoall_single(in_tensor, out_tensor, in_split_sizes,
                            out_split_sizes, group, sync_op)


def _alltoall_single(in_tensor, out_tensor=None, in_split_sizes=None,
                     out_split_sizes=None, group=None, sync_op=True):
    pg = _pg(group)
    new = out_tensor is None
    if new:
        if in_split_sizes is not None or out_split_sizes is not None:
            raise ValueError("uneven splits need out_tensor")
        out_tensor = torch.empty_like(in_tensor)
        sync_op = True
    staged = host_staged(group, in_tensor)
    src = _to_host(in_tensor) if staged else in_tensor.contiguous()
    buf = torch.empty_like(out_tensor, device="cpu") if staged else \
        out_tensor
    task = _issue(dist.all_to_all_single, buf, src,
                  output_split_sizes=out_split_sizes,
                  input_split_sizes=in_split_sizes, group=pg,
                  sync_op=sync_op,
                  then=_copy_back(out_tensor, buf) if staged else None)
    return out_tensor if new else task


@_timed("reduce_scatter")
def reduce_scatter(tensor: torch.Tensor, tensor_list: Optional[list] = None,
                   op: int = ReduceOp.SUM, group=None, sync_op: bool = True):
    """``reduce_scatter(out, tensor_list)``: ``out`` gets the group's
    reduction of everyone's ``tensor_list[i]``, ``i`` this rank's index
    (returns a :class:`Task`).  ``reduce_scatter(x)``: ``x``'s first axis
    in ``nranks`` chunks, this rank's chunk of the reduction returned.
    On gloo, CUDA tensors go through host copies (:func:`host_staged`)."""
    _observe("reduce_scatter", _nbytes(tensor) if tensor_list is None
             else _nbytes(*tensor_list))
    g = _group_of(group)
    if tensor_list is None:
        if tensor.shape[0] % g.nranks:
            raise ValueError(f"reduce_scatter: axis 0 of "
                             f"{tuple(tensor.shape)} does not split into "
                             f"{g.nranks} chunks")
        out = torch.empty_like(tensor.chunk(g.nranks, dim=0)[0])
        _reduce_scatter(out, list(tensor.chunk(g.nranks, dim=0)), op,
                        group, True)
        return out
    return _reduce_scatter(tensor, tensor_list, op, group, sync_op)


def _reduce_scatter(tensor, tensor_list, op, group, sync_op) -> Task:
    pg = _pg(group)
    top, n = _torch_op(op, group)
    staged = host_staged(group, tensor)
    ins = [_to_host(t) if staged else t.contiguous() for t in tensor_list]
    out = torch.empty_like(tensor, device="cpu") if staged else tensor
    return _issue(dist.reduce_scatter, out, ins, op=top, group=pg,
                  sync_op=sync_op,
                  then=_then(_copy_back(tensor, out) if staged else None,
                             _divide(tensor, n)))


# -- point to point --------------------------------------------------------------

@_timed("send")
def send(tensor: torch.Tensor, dst: int = 0, group=None,
         sync_op: bool = True) -> Task:
    """``tensor`` to the global rank ``dst`` (through a host copy on gloo
    for a CUDA tensor)."""
    pg = _pg(group)
    _observe("send", _nbytes(tensor))
    src = _to_host(tensor) if host_staged(group, tensor) else \
        tensor.contiguous()
    fn = dist.send if sync_op else dist.isend
    work = fn(src, dst=dst, group=pg)
    task = Task(None if sync_op else work)
    task._keep = src              # alive until the send completes
    return task


@_timed("recv")
def recv(tensor: torch.Tensor, src: int = 0, group=None,
         sync_op: bool = True) -> Task:
    """Into ``tensor``, from the global rank ``src`` (through a host copy
    on gloo for a CUDA tensor)."""
    pg = _pg(group)
    _observe("recv", _nbytes(tensor))
    staged = host_staged(group, tensor)
    buf = torch.empty_like(tensor, device="cpu") if staged else tensor
    back = _copy_back(tensor, buf) if staged else None
    if sync_op:
        dist.recv(buf, src=src, group=pg)
        if back is not None:
            back()
        return Task()
    return Task(dist.irecv(buf, src=src, group=pg), back)


def isend(tensor: torch.Tensor, dst: int = 0, group=None,
          sync_op: bool = False) -> Task:
    """:func:`send`, asynchronous unless ``sync_op`` (the JAX package's
    ``isend`` is its ``send``, whose ``sync_op`` this takes)."""
    return send(tensor, dst=dst, group=group, sync_op=sync_op)


def irecv(tensor: torch.Tensor, src: int = 0, group=None,
          sync_op: bool = False) -> Task:
    """:func:`recv`, asynchronous unless ``sync_op``."""
    return recv(tensor, src=src, group=group, sync_op=sync_op)


class P2POp:
    """One send or receive of :func:`batch_isend_irecv`: ``op`` is
    :func:`isend` or :func:`irecv`, ``peer`` a global rank."""

    def __init__(self, op, tensor: torch.Tensor, peer: int, group=None):
        if op not in (isend, irecv):
            raise ValueError("P2POp's op must be isend or irecv")
        self.op, self.tensor, self.peer, self.group = op, tensor, peer, group


def batch_isend_irecv(p2p_op_list: List[P2POp]) -> List[Task]:
    """Issue every operation together; returns their tasks (a received
    CUDA tensor on gloo is written when its task is waited for)."""
    ops, thens = [], []
    for p in p2p_op_list:
        _observe("send" if p.op is isend else "recv", _nbytes(p.tensor))
        staged = host_staged(p.group, p.tensor)
        if p.op is isend:
            t = _to_host(p.tensor) if staged else p.tensor
            ops.append(dist.P2POp(dist.isend, t, p.peer,
                                  group=_pg(p.group)))
            thens.append(None)
        else:
            t = torch.empty_like(p.tensor, device="cpu") if staged \
                else p.tensor
            ops.append(dist.P2POp(dist.irecv, t, p.peer,
                                  group=_pg(p.group)))
            thens.append(_copy_back(p.tensor, t) if staged else None)
    tasks = []
    for w, then, op in zip(dist.batch_isend_irecv(ops), thens, ops):
        task = Task(w, then)
        task._keep = op.tensor
        tasks.append(task)
    return tasks


@_timed("barrier")
def barrier(group=None) -> None:
    """Every rank of the group waits for the others."""
    pg = _pg(group)
    _observe("barrier", 0)
    dist.barrier(group=pg)


def wait(tensor: torch.Tensor, group=None, use_calc_stream: bool = True
         ) -> None:
    """Block until the work queued on ``tensor``'s card is done (a CPU
    tensor's collectives are complete when they return)."""
    if tensor.is_cuda:
        torch.cuda.synchronize(tensor.device)
