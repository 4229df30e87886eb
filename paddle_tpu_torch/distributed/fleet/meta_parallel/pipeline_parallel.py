"""Pipeline parallelism in the port: the 1F1B and interleaved schedules
and ``PipelineParallel`` (the counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py`` and
``pp_spmd.py``).

The JAX package compiles a GPipe-family ring into one ``lax.scan``;
pipelining "changes time, not math".  The port runs one process a stage
and the reference's host-driven schedule:

 - :func:`schedule_orders`: each rank's order of forward (``F``) and
   backward (``B``) passes of ``(micro-batch, virtual stage)``.  Virtual
   stage ``k`` lives on rank ``k % pp`` (rank ``s`` owns ``{g * pp +
   s}``, the JAX package's ``natural_stack`` ownership).  Forwards are
   taken in groups of ``pp`` micro-batches, each group through chunk 0,
   then chunk 1, ...; backwards the same with the chunks reversed.  A
   rank runs ``min(total, (pp - s - 1) * 2 + (v - 1) * pp)`` forwards
   first (``min(M, pp - s - 1)`` at ``v = 1``: 1F1B), then one forward,
   one backward, then the remaining backwards (Megatron's order, and
   with ``M`` not a multiple of ``pp`` the last group is short).
 - :func:`schedule_table`: the ticks.  Each rank runs its next pass as
   soon as its input was made at an earlier tick (one pass a tick), so
   with ``pp | M`` the schedule takes ``2 (M v + pp - 1)`` ticks and its
   idle share is ``1 - microbatch_utilization(M * v, pp)``; a stage
   holds at most ``pp - s`` activations at ``v = 1``.
 - :class:`PipelineEngine`: runs a table.  At each tick a rank runs its
   pass, then exchanges with its neighbours everything made at that
   tick (:class:`.pp_utils.P2PCommunicator`: one batched exchange, so
   the sends and receives of a tick cannot block each other).  Micro-
   batches are equal slices of the rank's batch; the last virtual
   stage's loss is divided by ``M`` before its backward, so the
   gradients are those of the mean over micro-batches of each one's
   mean: the batch's mean, the JAX step's.  The loss comes back to
   every rank of the pipe group by a broadcast from the last stage.
 - :class:`PipelineParallel`: ``train_batch`` / ``eval_batch`` over a
   :class:`.parallel_layers.PipelineLayer`: the engine's schedule, then
   the update of ``...sharding.ZeroPlan.step``, the same step body as
   ``train.HybridTrainStep``'s (gradients reduced over dp x sharding,
   shared layers summed over their stages, the clip told what each
   gradient is, ZeRO at ``os`` / ``os_g`` when the optimizer says).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from ... import collective as _c
from ...sharding.group_sharded import (ZeroPlan, local_batch,
                                       mean_over_data_ranks, zero_level)
from .pp_utils.p2p_communication import (META_LEN, P2PCommunicator,
                                         decode_meta, encode_meta)

__all__ = ["schedule_orders", "schedule_table", "idle_share", "residency",
           "microbatch_utilization", "PipelineEngine", "PipelineParallel"]

Op = Tuple[str, int, int]          # ("F" | "B", micro-batch, virtual stage)


def microbatch_utilization(num_microbatches: int, pp: int) -> float:
    """Share of ticks that are not bubble: ``M / (M + pp - 1)``."""
    return num_microbatches / (num_microbatches + pp - 1)


def _chunk_order(M: int, pp: int, v: int, forward: bool) -> List[tuple]:
    out = []
    for start in range(0, M, pp):
        group = range(start, min(start + pp, M))
        for g in (range(v) if forward else reversed(range(v))):
            out.extend((mb, g) for mb in group)
    return out


def schedule_orders(pp: int, M: int, v: int = 1) -> List[List[Op]]:
    """Each rank's passes in order (module docstring)."""
    if pp < 1 or M < 1 or v < 1:
        raise ValueError(f"pp {pp}, micro-batches {M}, virtual stages {v}")
    orders = []
    for s in range(pp):
        total = M * v
        warm = min(M, pp - s - 1) if v == 1 else \
            min(total, (pp - s - 1) * 2 + (v - 1) * pp)
        fwd = [("F", mb, g * pp + s) for mb, g in _chunk_order(M, pp, v, True)]
        bwd = [("B", mb, g * pp + s)
               for mb, g in _chunk_order(M, pp, v, False)]
        order = fwd[:warm]
        for i in range(total - warm):
            order += [fwd[warm + i], bwd[i]]
        order += bwd[total - warm:]
        orders.append(order)
    return orders


def schedule_table(pp: int, M: int, v: int = 1) -> List[List[Optional[Op]]]:
    """``table[t][s]``: the pass rank ``s`` runs at tick ``t`` (None:
    idle).  Raises if the orders cannot all run."""
    orders = schedule_orders(pp, M, v)
    last = pp * v - 1
    done: Dict[Op, int] = {}
    pos = [0] * pp
    table = []
    t = 0
    while any(pos[s] < len(orders[s]) for s in range(pp)):
        row: List[Optional[Op]] = [None] * pp
        for s in range(pp):
            if pos[s] == len(orders[s]):
                continue
            kind, mb, k = orders[s][pos[s]]
            if kind == "F":
                need = [("F", mb, k - 1)] if k > 0 else []
            else:
                need = [("F", mb, k)] + (
                    [("B", mb, k + 1)] if k < last else [])
            if all(done.get(n, t) < t for n in need):
                row[s] = orders[s][pos[s]]
        if not any(row):
            raise RuntimeError(f"the schedule of pp {pp}, M {M}, v {v} "
                               f"cannot proceed at tick {t}")
        for s, op in enumerate(row):
            if op is not None:
                done[op] = t
                pos[s] += 1
        table.append(row)
        t += 1
    return table


def idle_share(table) -> float:
    """Idle (rank, tick) slots over all of them."""
    slots = len(table) * len(table[0])
    return sum(op is None for row in table for op in row) / slots


def residency(table, stage: int) -> int:
    """The most forward passes stage ``stage`` holds at once (run, their
    backward not yet)."""
    held = worst = 0
    for row in table:
        op = row[stage]
        if op is not None:
            held += 1 if op[0] == "F" else -1
            worst = max(worst, held)
    return worst


class PipelineEngine:
    """Runs the schedule of ``pp`` stages, ``M`` micro-batches and ``v``
    virtual stages for this rank (``hcg``'s pipe group and stage).

    :meth:`run` takes ``forward(k, x, mb)`` (virtual stage ``k`` on its
    input ``x``, micro-batch ``mb``'s inputs for ``k == 0``; for the last
    virtual stage it returns micro-batch ``mb``'s loss, a 0-d tensor) and
    returns the mean loss over micro-batches, on every rank of the pipe
    group."""

    def __init__(self, hcg, num_microbatches: int, virtual_stages: int = 1):
        self.hcg = hcg
        self.group = hcg.get_pipe_parallel_group()
        self.pp = hcg.get_pipe_parallel_world_size()
        self.stage = hcg.get_stage_id()
        self.M, self.v = int(num_microbatches), int(virtual_stages)
        self.last = self.pp * self.v - 1
        self.table = schedule_table(self.pp, self.M, self.v)
        self.comm = P2PCommunicator(self.group)
        self.ranks = self.group.ranks
        # the tick of each virtual stage's first forward send, where its
        # activations' meta travels (once for a micro-batch shape: then
        # kept in _metas on both sides, so a replay exchanges none)
        self._metas: Dict[tuple, Dict[int, tuple]] = {}
        self._first_send = {}
        for t, row in enumerate(self.table):
            for op in row:
                if op is not None and op[0] == "F" and op[2] < self.last:
                    self._first_send.setdefault(op[2], t)

    def _dst(self, op: Op) -> Optional[int]:
        kind, _, k = op
        if kind == "F":
            return None if k == self.last else (k + 1) % self.pp
        return None if k == 0 else (k - 1) % self.pp

    def micro(self, t: torch.Tensor, mb: int) -> torch.Tensor:
        """Micro-batch ``mb``'s rows of ``t`` (``M`` equal slices)."""
        if t.shape[0] % self.M:
            raise ValueError(f"a rank's batch of {t.shape[0]} does not split "
                             f"into {self.M} micro-batches")
        per = t.shape[0] // self.M
        return t.narrow(0, mb * per, per)

    def run_batch(self, chunk: Callable, loss_fn: Callable,
                  inputs: torch.Tensor, targets: torch.Tensor,
                  backward: bool = True) -> torch.Tensor:
        """The schedule over this rank's ``inputs`` and ``targets`` cut
        into micro-batches: ``chunk(k, x)`` runs virtual stage ``k``, and
        the last one's output goes through ``loss_fn(y, targets)`` with
        the micro-batch's targets.  Returns :meth:`run`'s loss; without
        ``backward`` only the forwards run, under ``no_grad``."""
        def forward(k, x, mb):
            y = chunk(k, x)
            if k == self.last:
                return loss_fn(y, self.micro(targets, mb)).float()
            return y

        def mb_inputs(mb):
            return self.micro(inputs, mb)

        if backward:
            return self.run(forward, mb_inputs, inputs.device)
        with torch.no_grad():
            return _forward_only(self, forward, mb_inputs, inputs.device)

    def run(self, forward: Callable, mb_inputs: Callable[[int], object],
            device) -> torch.Tensor:
        """The whole schedule: forwards, backwards, the exchanges; the
        gradients accumulate in the parameters' ``.grad``."""
        s, M = self.stage, self.M
        acts: Dict[tuple, tuple] = {}       # (mb, k) -> (input, output)
        inbox: Dict[Op, torch.Tensor] = {}  # received, by the op that made it
        meta, known = self._meta_for(mb_inputs)
        total = torch.zeros((), dtype=torch.float32, device=device)
        for t, row in enumerate(self.table):
            op = row[s]
            made = None
            if op is not None:
                kind, mb, k = op
                if kind == "F":
                    if k == 0:
                        x = mb_inputs(mb)
                    else:
                        x = inbox.pop(("F", mb, k - 1)).requires_grad_()
                    y = forward(k, x, mb)
                    if k == self.last:
                        total += y.detach().float()
                        acts[mb, k] = (x, y.float() / M)
                    else:
                        acts[mb, k] = (x, y)
                        meta.setdefault(k, (tuple(y.shape), y.dtype))
                        made = y.detach()
                else:
                    x, y = acts.pop((mb, k))
                    if k == self.last:
                        torch.autograd.backward(y)
                    else:
                        torch.autograd.backward(
                            y, grad_tensors=inbox.pop(("B", mb, k + 1)))
                    if k > 0:
                        made = x.grad
            self._exchange(t, row, op, made, inbox, meta, acts, device,
                           known)
        loss = total / M
        src = self.ranks[(self.last) % self.pp]
        _c.broadcast(loss, src=src, group=self.group)
        return loss

    def _meta_for(self, mb_inputs):
        """(k -> (shape, dtype) of virtual stage k's activations for this
        micro-batch shape, whether it is already known)."""
        key = tuple(mb_inputs(0).shape)
        known = key in self._metas
        return self._metas.setdefault(key, {}), known

    def _exchange(self, t, row, op, made, inbox, meta, acts, device,
                  known=False):
        """Tick ``t``'s exchange: this rank's output (``made``) to the
        rank of the next (forward) or previous (backward) virtual stage,
        and what the other ranks made at ``t`` for this one; a virtual
        stage's first activation is preceded by its meta unless it is
        ``known``."""
        s = self.stage
        sends, meta_sends = [], []
        if made is not None:
            dst = self.ranks[self._dst(op)]
            if op[0] == "F" and not known and \
                    self._first_send.get(op[2]) == t:
                meta_sends.append((encode_meta(made), dst))
            sends.append((made, dst))
        incoming = [(p, o) for p, o in enumerate(row)
                    if p != s and o is not None and self._dst(o) == s]
        firsts = [] if known else [
            (p, o) for p, o in incoming
            if o[0] == "F" and self._first_send.get(o[2]) == t]
        bufs = [torch.zeros(META_LEN, dtype=torch.int64, device=device)
                for _ in firsts]
        if meta_sends or firsts:
            self.comm.exchange(meta_sends, [(b, self.ranks[p]) for b, (p, _)
                                            in zip(bufs, firsts)])
            for b, (_, o) in zip(bufs, firsts):
                meta[o[2]] = decode_meta(b)
        recvs = []
        for p, o in incoming:
            kind, mb, k = o
            if kind == "F":
                shape, dtype = meta[k]
            else:       # the gradient of this rank's output of stage k - 1
                y = acts[mb, k - 1][1]
                shape, dtype = tuple(y.shape), y.dtype
            buf = torch.empty(shape, dtype=dtype, device=device)
            inbox[o] = buf
            recvs.append((buf, self.ranks[p]))
        if sends or recvs:
            self.comm.exchange(sends, recvs)


class PipelineParallel(torch.nn.Module):
    """``fleet.distributed_model``'s wrapper in pipeline mode: the
    schedule over a :class:`.parallel_layers.PipelineLayer` built for
    this rank's stage.  ``pipeline_configs``' ``accumulate_steps`` sets
    the micro-batches (at least ``pp``, as the JAX package's compiled
    path takes) and ``virtual_pp_degree`` must match the layer's.

    ``train_batch((inputs, labels), optimizer, lr_scheduler)`` takes the
    global batch, keeps this data rank's rows
    (``...sharding.local_batch``: data rank ``r`` of dp x sharding, as
    ``train.HybridTrainStep`` does), runs the schedule and then
    ``...sharding.ZeroPlan.step`` over the layer's parameters: the
    gradients averaged over the data ranks, the shared layers' summed
    over their stages, the clip (of ``optimizer`` as
    ``fleet.distributed_optimizer`` wraps it, which is done here when
    the caller has not) over every element of the model once, the
    update (its state lives here, :attr:`state`), at the ZeRO level
    ``os`` or ``os_g`` when the optimizer carries one and the sharding
    degree is above 1.  Then it steps the schedule and returns the loss
    of the global batch on every rank.  Stage 3 (``p_g_os``) over a
    ``PipelineLayer`` is not ported (``train.build_train_step`` runs it
    for GPT); nor is a dynamic loss scaler (ROADMAP Queue 1, item 9)."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        from .parallel_layers.pp_layers import PipelineLayer
        if not isinstance(layers, PipelineLayer):
            raise TypeError("PipelineParallel expects a PipelineLayer")
        if hcg is None:
            from ..fleet import get_hybrid_communicate_group
            hcg = get_hybrid_communicate_group()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        cfg = strategy.pipeline_configs if strategy is not None else {}
        self.accumulate_steps = int(cfg.get("accumulate_steps", 1))
        self.virtual_pp_degree = layers.num_virtual_stages
        pp = hcg.get_pipe_parallel_world_size()
        self.num_microbatches = max(self.accumulate_steps, pp)
        self._engine = PipelineEngine(hcg, self.num_microbatches,
                                      self.virtual_pp_degree)
        self.state = None
        self._opt = None
        self._zero = None
        self.total_loss = None

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def _plan(self, optimizer):
        """(the ZeroPlan, the wrapped optimizer) of ``optimizer``, made
        with its state when the optimizer changes."""
        if self._opt is not optimizer:
            from ..meta_optimizers import HybridParallelOptimizer
            hcg = self._hcg
            opt = optimizer if isinstance(optimizer, HybridParallelOptimizer) \
                else HybridParallelOptimizer(optimizer, hcg)
            level = zero_level(opt) \
                if hcg.get_sharding_parallel_world_size() > 1 else None
            if level == "p_g_os":
                raise NotImplementedError(
                    "stage 3 (p_g_os) over a PipelineLayer is not ported; "
                    "train.build_train_step runs it for GPT")
            self._zero = ZeroPlan(dict(self._layers.named_parameters()),
                                  hcg, level,
                                  tied=self._layers.shared_weights())
            self._opt, self._wrapped = optimizer, opt
            self.state = self._zero.init_state(opt)
        return self._zero, self._wrapped

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        if scaler is not None:
            raise NotImplementedError(
                "the pipeline's dynamic loss scaler waits for the port's "
                "GradScaler (ROADMAP Queue 1, item 9)")
        layer = self._layers
        if layer._loss_fn is None:
            raise ValueError("train_batch needs PipelineLayer(loss_fn=...)")
        inputs, labels = local_batch(tuple(data), self._hcg)
        zero, opt = self._plan(optimizer)
        opt.write_lr()
        loss = self._engine.run_batch(layer.forward_chunk, layer._loss_fn,
                                      inputs, labels)
        loss = zero.step(opt, self.state, loss)
        if lr_scheduler is not None:
            lr_scheduler.step()
        self.total_loss = loss
        return loss

    def eval_batch(self, data, compute_loss=True):
        """The loss of the global batch (forwards only), on every rank."""
        if not compute_loss:
            raise NotImplementedError("eval_batch without a loss is not "
                                      "ported: the outputs stay on the "
                                      "last stage")
        layer = self._layers
        inputs, labels = local_batch(tuple(data), self._hcg)
        loss = self._engine.run_batch(layer.forward_chunk, layer._loss_fn,
                                      inputs, labels, backward=False)
        return mean_over_data_ranks(loss, self._hcg)

    def forward_backward_pipeline(self, data, optimizer, scaler=None):
        return self.train_batch(data, optimizer, scaler=scaler)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def parameters(self, recurse: bool = True):
        return self._layers.parameters(recurse)

    def named_parameters(self, *args, **kwargs):
        return self._layers.named_parameters(*args, **kwargs)


def _forward_only(engine: PipelineEngine, forward, mb_inputs, device):
    """The forwards of the schedule in its order, no backward: each rank
    runs its forwards and exchanges as in :meth:`PipelineEngine.run`."""
    s, M = engine.stage, engine.M
    table = [[op if op is not None and op[0] == "F" else None for op in row]
             for row in engine.table]
    inbox: Dict[Op, torch.Tensor] = {}
    meta, known = engine._meta_for(mb_inputs)
    total = torch.zeros((), dtype=torch.float32, device=device)
    for t, row in enumerate(table):
        op = row[s]
        made = None
        if op is not None:
            _, mb, k = op
            x = mb_inputs(mb) if k == 0 else inbox.pop(("F", mb, k - 1))
            y = forward(k, x, mb)
            if k == engine.last:
                total += y.float()
            else:
                meta.setdefault(k, (tuple(y.shape), y.dtype))
                made = y
        engine._exchange(t, row, op, made, inbox, meta, {}, device, known)
    loss = total / M
    _c.broadcast(loss, src=engine.ranks[engine.last % engine.pp],
                 group=engine.group)
    return loss
