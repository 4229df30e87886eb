"""The GPT training step of ``bench.py::bench_gpt`` and the BERT
pretraining step (MLM + NSP), and a CLI that runs either.

    python -m paddle_tpu_torch.train --model gpt_345m --batch 8 --seq 1024 --no-recompute
    python -m paddle_tpu_torch.train --model gpt_345m --batch 16 --seq 1024 --steps 8
    python -m paddle_tpu_torch.train --model bert_base --batch 32 --seq 128 --steps 8
    python -m paddle_tpu_torch.train --model gpt_tiny --batch 2 --seq 64 --steps 4 --device cpu
    python -m paddle_tpu_torch.train --dp 2 --mp 2 --batch 8 --no-recompute
    python -m paddle_tpu_torch.train --model gpt_tiny --dp 2 --mp 2 --batch 4 --seq 64 --device cpu
    python -m paddle_tpu_torch.train --model gpt_tiny --pp 2 --sharding 2 --batch 8 --seq 64 --device cpu
    python -m paddle_tpu_torch.train --model gpt_tiny --sep 2 --batch 2 --seq 64 --device cpu

The GPT step: ``GPTForCausalLM`` (recompute per block unless
``--no-recompute``), the causal-LM loss.  The BERT step:
``BertForPretraining`` (no recompute) and ``BertPretrainingCriterion`` on
a phase-1-style masked batch (:func:`make_bert_batch`).  Both: dropout
0.1 on the hidden states and the attention probabilities, AMP O2 in
bf16, the loss in f32, the backward pass, and ``AdamW(1e-4)`` with f32
master weights and weight decay 0.01 on every parameter (the builders
take any ``optimizer=``: a schedule, a clip, another optimizer).  The
fusion pass (:mod:`.ops.fusion_pass`) rewrites the model's clusters to the block
kernels unless ``--no-fusion`` or ``PT_FUSION_PASS=0``, as the JAX
package applies it to bench's GPT step, captured steps and hapi.  Batches come from
``np.random.RandomState(0)``; one generator seeded with 0 draws the
weights and then every dropout mask.  The CLI prints each step's loss
and time, then the median step time, sequences and tokens per second,
and the capture's ``compiles``, ``hits`` and ``fallback``.  It runs on
``cuda`` unless ``--device cpu`` is given, and raises when there is no
GPU.  On the card each step is replayed as a CUDA graph
(:mod:`.jit.capture`; the first call warms up and captures) unless
``PT_CAPTURE=0``.

With ``--dp`` and ``--mp`` (GPT) the CLI spawns ``dp * mp`` ranks
(:func:`.distributed.spawn`), each building :func:`build_train_step`'s
hybrid step through ``fleet``: data parallelism over ``dp`` ranks, each
taking its slice of the batch, and tensor parallelism over ``mp``.  On
cards the backend is NCCL, one card a rank, and the step is captured;
``--backend gloo`` lets ranks share a card and runs the step eagerly, as
on the CPU (gloo's collectives run on the host).  Rank 0 prints.

Started by the launcher (``python -m paddle_tpu_torch.distributed.launch
--nproc_per_node N``, ``PADDLE_TRAINERS_NUM`` = N, the product of the
degrees) the CLI spawns nothing: each launched process is one rank.

With ``--pp`` (pipeline stages, ``--microbatches`` and
``--virtual-stages``) and ``--sharding`` (ZeRO over ``--sharding-level``
``os``, ``os_g`` or ``p_g_os``; ``os_g`` by default) the ranks are
``dp * mp * pp * sharding``: each pipeline stage runs its virtual
stages of the 1F1B schedule and each ZeRO rank holds its windows of the
optimizer state (:class:`HybridTrainStep`).  With ``--sep`` each
sequence is split over the sep ranks (ring attention over the sep group;
not with ``--pp``), the ranks ``dp * mp * pp * sharding * sep``.
"""
from __future__ import annotations

import argparse
import copy
import inspect
import json
import logging
import os
import statistics
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .amp import decorate
from .device import resolve_device
from .distributed.checkpoint import copy_into
from .distributed.collective import ReduceOp, all_reduce
from .distributed.parallel import unwrap_model
from .distributed.sharding.group_sharded import gathered, local_batch
from .framework.random import make_generator, restore_generator_state
from .jit import capture_step
from .incubate.models import (BertConfig, BertForPretraining,
                              BertPretrainingCriterion, GPTConfig,
                              GPTForCausalLM, GPTPretrainingCriterion,
                              bert_base, bert_tiny, gpt_13b, gpt_1p3b,
                              gpt_345m, gpt_6p7b, gpt_tiny)
from .ops.fusion_pass import fusion_enabled, wrap
from .optimizer import AdamW, Optimizer

__all__ = ["TrainStep", "EagerStep", "HybridTrainStep", "HybridEagerStep",
           "build_train_step", "hybrid_gpt_step", "make_batch",
           "build_bert_pretrain_step", "make_bert_batch", "save_checkpoint",
           "restore_checkpoint", "main"]

logger = logging.getLogger("paddle_tpu_torch.checkpoint")

CONFIGS = {"gpt_tiny": gpt_tiny, "gpt_345m": gpt_345m,
           "gpt_1p3b": gpt_1p3b, "gpt_6p7b": gpt_6p7b, "gpt_13b": gpt_13b,
           "bert_tiny": bert_tiny, "bert_base": bert_base}
#: the CLI's batch and sequence when none is given: bench_gpt's, and
#: BERT's phase-1 pretraining shape (bench.py's BERT_SEQ)
DEFAULT_SHAPE = {"gpt": (16, 1024), "bert": (32, 128)}
WORD_EMBEDDING = "gpt.embeddings.word_embeddings.weight"
MASK_TOKEN = 103                 # [MASK] in BERT's uncased vocabulary
MAX_PREDICTIONS = 20             # MLM targets per sequence, phase 1


class EagerStep:
    """One optimizer step, run eagerly: loss of ``model`` on a batch, its
    gradients, and the optimizer's update of every parameter (``params``,
    with the optimizer's ``state``), in place; ``generator`` feeds every
    dropout (passed to ``model`` as ``generator=`` when
    ``takes_generator``).  Each parameter's gradient is dropped after the
    update, so under capture the gradients live in the graph's memory
    pool.  The update reads the learning rate from
    ``optimizer.lr_tensor``: a caller that runs this step directly under
    a schedule calls ``optimizer.write_lr()`` first, as
    :class:`TrainStep` does.  A distributed step names the other
    generators its model draws from (``generators``, so a CUDA graph
    registers them), the process groups of its collectives (``groups``),
    and the data-parallel group the returned loss is averaged over
    (``loss_group``)."""

    def __init__(self, model, criterion, optimizer, generator, params,
                 state, *, takes_generator: bool = True,
                 outputs: bool = False, generators=(), groups=(),
                 loss_group=None):
        self.model, self.criterion = model, criterion
        self.optimizer, self.generator = optimizer, generator
        self.params, self.state = params, state
        self.takes_generator, self.outputs = takes_generator, outputs
        self.generators = [g for g in generators if g is not generator]
        self.groups, self.loss_group = list(groups), loss_group

    def loss_of(self, inputs, targets):
        """The forward pass and the f32 loss: ``(loss, outputs)``, the
        outputs a tuple."""
        kw = {"generator": self.generator} if self.takes_generator else {}
        if isinstance(inputs, dict):
            out = self.model(**inputs, **kw)
        elif isinstance(inputs, (list, tuple)):
            out = self.model(*inputs, **kw)
        else:
            out = self.model(inputs, **kw)
        out = out if isinstance(out, tuple) else (out,)
        if isinstance(targets, dict):
            loss = self.criterion(*out, **targets)
        elif isinstance(targets, (list, tuple)):
            loss = self.criterion(*out, *targets)
        else:
            loss = self.criterion(*out, targets)
        return loss.float(), out

    def __call__(self, inputs, targets):
        loss, out = self.loss_of(inputs, targets)
        loss.backward()
        grads = {n: p.grad for n, p in self.params.items()}
        self.optimizer.apply_gradients_tree(self.params, grads, self.state)
        for p in self.params.values():
            p.grad = None
        loss = loss.detach()
        if self.loss_group is not None:
            loss = loss.clone()
            all_reduce(loss, op=ReduceOp.AVG, group=self.loss_group)
        if self.outputs:
            return loss, tuple(o.detach() for o in out)
        return loss


class TrainStep:
    """One optimizer step: loss of ``model`` on a batch, its gradients,
    and the optimizer's update of every parameter, in place.  The
    optimizer state lives in ``self.state``; ``generator`` feeds every
    dropout, passed to the model as ``generator=`` when its ``forward``
    takes one.  The criterion takes the model's outputs (all of them, when
    the model returns a tuple), then the targets.  With ``outputs`` a call
    returns ``(loss, outputs)``, the model's outputs detached (hapi's
    metrics read them).  With ``fusion`` (by
    default when ``fusion_enabled()``) the model runs under the fusion
    pass (``self.model`` is the wrapped module, on the same
    parameters).  Calling the step runs it through
    :func:`.jit.capture_step` (``self.captured``): on the card a CUDA
    graph replays it; on the CPU, or with ``PT_CAPTURE=0``, it runs
    eagerly.  With ``capture=False`` it is never captured
    (``self.captured`` is None): the caller's choice for a step whose
    collectives run on gloo, which :func:`.jit.capture_step` refuses.
    ``self.eager`` (:class:`EagerStep`) is the step itself,
    uncaptured; it does not refer back to this object, so dropping the
    step frees its graphs at once.  ``generators``, ``groups`` and
    ``loss_group`` are :class:`EagerStep`'s."""

    def __init__(self, model: torch.nn.Module, criterion: torch.nn.Module,
                 optimizer: Optimizer, generator: torch.Generator, *,
                 fusion: Optional[bool] = None, outputs: bool = False,
                 capture: bool = True, generators=(), groups=(),
                 loss_group=None):
        model.train()
        if fusion is None:
            fusion = fusion_enabled()
        self.model = wrap(model) if fusion else model
        self.criterion = criterion
        self.optimizer = optimizer
        self.generator = generator
        self.params: Dict[str, torch.nn.Parameter] = dict(
            model.named_parameters())
        self.state = optimizer.init_state_tree(self.params)
        takes = "generator" in inspect.signature(
            unwrap_model(model).forward).parameters
        self.eager = EagerStep(self.model, criterion, optimizer, generator,
                               self.params, self.state,
                               takes_generator=takes, outputs=outputs,
                               generators=generators, groups=groups,
                               loss_group=loss_group)
        self.captured = capture_step(self.eager) if capture else None

    def __call__(self, inputs, targets):
        """Run the step on the model's ``inputs`` and the criterion's
        ``targets``, each one tensor (GPT's ids and labels), a tuple of
        positional arguments (hapi's batches) or a dict of keyword
        arguments (:func:`make_bert_batch`); returns the f32 loss (before
        the update).  The optimizer's learning rate
        (``get_lr()``: its scheduler's value, or ``set_lr``'s) is first
        written into its tensor on the device, outside the graph, which
        reads it at each replay."""
        self.optimizer.write_lr()
        if self.captured is None:
            return self.eager(inputs, targets)
        return self.captured(inputs, targets)

    # -- checkpoints -----------------------------------------------------------
    def checkpoint_tree(self) -> dict:
        """The step's state in hapi's sharded layout, so either package
        reads what the other wrote: ``{"params": {name: t}, "opt_tree":
        {"slots": {slot: {name: t}}, "master": {name: t}, "step": t},
        "rng": generator state}``.  The tensors are the live ones (a
        save copies them to the host); ``rng`` (the dropout generator's
        ``get_state()``, a uint8 tensor) is the one leaf the JAX package
        does not have, and its templates ignore it."""
        return {"params": dict(self.params), "opt_tree": self.state,
                "rng": self.generator.get_state()}

    def data_state(self) -> dict:
        """What rides beside the tensors as JSON: the learning-rate
        schedule's ``state_dict()`` under the optimizer's own key,
        ``LR_Scheduler`` (empty without a schedule)."""
        sched = self.optimizer._learning_rate_scheduler
        return {} if sched is None else {"LR_Scheduler": sched.state_dict()}

    #: the mesh of a sharded step's checkpoints; a single process's
    #: leaves are whole
    checkpoint_mesh = None

    def full_opt_tree(self, opt_tree: dict) -> dict:
        """``opt_tree`` as a checkpoint holds it, with the empty subtrees
        that have no leaves on disk (``master`` in an f32 run, SGD's
        slots) rebuilt, so that it has :attr:`state`'s layout."""
        ot = dict(opt_tree)
        ot["slots"] = dict(ot.get("slots", {}))
        ot.setdefault("master", {})
        for s in self.optimizer._state_slots:
            ot["slots"].setdefault(s, {})
        return ot

    def load_checkpoint_tree(self, tree: dict,
                             data_state: Optional[dict] = None, *,
                             template: Optional[dict] = None) -> None:
        """Restore a checkpoint tree (:meth:`checkpoint_tree`'s layout, as
        ``load_sharded`` returns it, with or without a template) into
        this step in place: parameters, masters, slots and the step count
        are copied into the live tensors (a captured graph reads them
        where they are), the generator is set to ``rng`` when the tree
        has it, and a schedule to ``data_state["LR_Scheduler"]``, whose
        rate is then written into ``optimizer.lr_tensor``.  Empty
        subtrees that have no leaves on disk are rebuilt
        (:meth:`full_opt_tree`).  Raises
        ``KeyError`` for a tensor the tree lacks and ``ValueError`` for
        one of another shape or dtype.  With ``template`` (what
        ``load_sharded`` loaded the tree for), an ``rng`` that is the
        template's own (the checkpoint, saved at another layout, has no
        single-process generator) is left, and a log line says so."""
        copy_into({"params": self.params, "opt_tree": self.state},
                  {"params": tree.get("params", {}),
                   "opt_tree": self.full_opt_tree(tree.get("opt_tree", {}))})
        rng = tree.get("rng")
        if template is not None and rng is not None and \
                rng is template.get("rng"):
            logger.warning("checkpoint: no generator state of a single "
                           "process (saved at another layout): the dropout "
                           "generator is not restored")
        elif rng is not None:
            restore_generator_state(self.generator, rng)
        self._restore_schedule(data_state)

    def _restore_schedule(self, data_state: Optional[dict]) -> None:
        """The schedule's state from ``data_state["LR_Scheduler"]``, and
        the rate written into ``optimizer.lr_tensor``."""
        sched = self.optimizer._learning_rate_scheduler
        if sched is not None and data_state and \
                "LR_Scheduler" in data_state:
            sched.set_state_dict(copy.deepcopy(data_state["LR_Scheduler"]))
        self.optimizer.write_lr()


class HybridEagerStep(EagerStep):
    """The body of a ZeRO or pipelined :class:`HybridTrainStep`, one
    rank's share: the forward and backward passes (the schedule of
    ``engine``, a pipeline's :class:`PipelineEngine`, when there is
    one), then ``zero.step`` (``zero``: a
    :class:`.distributed.sharding.ZeroPlan`), the update body that
    ``PipelineParallel.train_batch`` runs too: the gradients reduced
    over dp x sharding, the tied embedding's copies summed, the clip and
    the update of this rank's windows, the windows gathered, the loss
    averaged over the data ranks."""

    def __init__(self, model, criterion, optimizer, generator, params,
                 state, *, zero, engine=None, generators=(), groups=(),
                 takes_generator: bool = True):
        super().__init__(model, criterion, optimizer, generator, params,
                         state, generators=generators, groups=groups,
                         takes_generator=takes_generator)
        self.zero, self.engine = zero, engine

    def __call__(self, inputs, targets):
        net = unwrap_model(self.model)
        if self.engine is not None:
            def chunk(k, x):
                with gathered(net):
                    return net.forward_chunk(k, x, generator=self.generator)

            loss = self.engine.run_batch(chunk, self.criterion, inputs,
                                         targets)
        else:
            with gathered(net):
                loss, _ = self.loss_of(inputs, targets)
            loss.backward()
        return self.zero.step(self.optimizer, self.state, loss)


class HybridTrainStep(TrainStep):
    """One rank's share of a hybrid-parallel step (``hcg``: fleet's
    topology).  A call takes the global batch and keeps this data rank's
    rows (:func:`.distributed.sharding.local_batch`: data rank ``r`` of
    dp x sharding) and this sep rank's positions of them; the loss it
    returns is averaged over the data and sep ranks (and, pipelined,
    broadcast from the last stage), so every rank returns the global
    batch's loss.

    At data x tensor parallelism (pp = sharding = 1) the model is
    wrapped by ``DataParallel``, whose buckets reduce the gradients in
    the backward pass, overlapped with it, and the step is
    :class:`TrainStep`'s.  With ``zero`` (a
    :class:`.distributed.sharding.ZeroPlan` over the model's
    parameters, which a sharding group or a pipeline needs) and
    ``engine`` (a pipeline's :class:`PipelineEngine`) the step is a
    :class:`HybridEagerStep`, whose reduction runs once after the whole
    backward pass (a pipeline's spans every micro-batch; ``os_g``
    reduce-scatters).  Collectives run on the hybrid groups: captured on
    NCCL, eager on gloo (``capture=False``)."""

    def __init__(self, model, criterion, optimizer, generator, hcg, *,
                 capture: bool = True, generators=(), outputs: bool = False,
                 zero=None, engine=None):
        self.hcg = hcg
        dp_group = hcg.get_dp_sep_parallel_group()
        groups = [g for g in (dp_group, hcg.get_model_parallel_group(),
                              hcg.get_sep_parallel_group(),
                              hcg.get_sharding_parallel_group(),
                              hcg.get_pipe_parallel_group())
                  if g is not None]
        self.zero, self.engine = zero, engine
        if zero is None:
            super().__init__(model, criterion, optimizer, generator,
                             fusion=False, outputs=outputs, capture=capture,
                             generators=generators, groups=groups,
                             loss_group=None if dp_group.nranks == 1
                             else dp_group)
            return
        if outputs:
            raise NotImplementedError("outputs of a ZeRO or pipelined step "
                                      "are not ported")
        model.train()
        self.model, self.criterion = model, criterion
        self.optimizer, self.generator = optimizer, generator
        self.params = dict(unwrap_model(model).named_parameters())
        self.state = zero.init_state(optimizer)
        takes = "generator" in inspect.signature(
            unwrap_model(model).forward).parameters
        self.eager = HybridEagerStep(
            model, criterion, optimizer, generator, self.params, self.state,
            zero=zero, engine=engine, generators=generators, groups=groups,
            takes_generator=takes)
        self.captured = capture_step(self.eager) if capture else None

    def __call__(self, inputs, targets):
        return super().__call__(local_batch(inputs, self.hcg),
                                local_batch(targets, self.hcg))

    @property
    def checkpoint_mesh(self):
        """The rank mesh this step's checkpoints are laid out on."""
        return self.hcg.mesh

    def checkpoint_tree(self) -> dict:
        """This rank's share of the step's state, each tensor a
        :class:`.distributed.checkpoint.ShardWindow` of the leaf the JAX
        package's ``build_train_step`` state holds at the same mesh
        (:mod:`.distributed.checkpoint_layout`): the tensor-parallel
        slices, the ZeRO windows (at every level), a pipeline stage's
        rows of the stacked ``__ppstack__`` leaves, the data and sep
        replicas written once; ``rng`` holds this rank's generators under
        its layout.  The windows refer to the live tensors; every rank
        saves it into the same directory (``save_sharded`` or a
        :class:`~.distributed.CheckpointManager`), and it is the template
        that loads this rank's windows of a checkpoint saved at any
        layout."""
        from .distributed.checkpoint_layout import checkpoint_tree
        return checkpoint_tree(self, unwrap_model(self.model))

    def load_checkpoint_tree(self, tree: dict,
                             data_state: Optional[dict] = None, *,
                             template: Optional[dict] = None) -> None:
        """Restore a tree that ``load_sharded`` returned for
        :meth:`checkpoint_tree`'s ``template`` (or the whole leaves of a
        checkpoint saved at this layout) into this rank's live tensors in
        place; the generators too when the checkpoint holds them for this
        layout and rank (otherwise a log line says so: dropout streams do
        not carry over to another layout), and the schedule's state."""
        from .distributed.checkpoint_layout import load_tree
        load_tree(self, unwrap_model(self.model), tree, template)
        self._restore_schedule(data_state)


def save_checkpoint(manager, step_no: int, train_step: TrainStep, *,
                    block: bool = False,
                    data_state: Optional[dict] = None) -> None:
    """Save ``train_step``'s state as step ``step_no`` through
    ``manager`` (a :class:`~.distributed.CheckpointManager`), the
    schedule's state in its ``data_state`` beside ``data_state``'s keys.
    In async mode the host copy is complete when this returns, so the
    next step may overwrite the tensors."""
    extra = dict(data_state or {})
    extra.update(train_step.data_state())
    manager.save(step_no, train_step.checkpoint_tree(), block=block,
                 data_state=extra or None)


def restore_checkpoint(manager, train_step: TrainStep) -> Optional[int]:
    """Restore the newest valid checkpoint of ``manager`` into
    ``train_step`` in place (falling back past corrupt steps; every rank
    of a hybrid step the same step), each tensor read onto the device of
    the tensor it replaces, a hybrid step's windows at its mesh, from a
    checkpoint saved at any layout; returns its step number, or None
    when there is none."""
    template = train_step.checkpoint_tree()
    tree, n = manager.restore_latest(template, train_step.checkpoint_mesh)
    if n is None:
        return None
    train_step.load_checkpoint_tree(tree, manager.load_data_state(n),
                                    template=template)
    return n


def _default_optimizer() -> Optimizer:
    return AdamW(learning_rate=1e-4, multi_precision=True)


def build_train_step(cfg: GPTConfig, *, device=None, seed: int = 0,
                     amp_o2: bool = True, fusion: Optional[bool] = None,
                     optimizer: Optional[Optimizer] = None, dp: int = 1,
                     mp: int = 1, pp: int = 1, sharding: int = 1,
                     sharding_level: Optional[str] = None,
                     microbatches: Optional[int] = None,
                     virtual_stages: int = 1, strategy=None,
                     capture: bool = True, sep: int = 1) -> TrainStep:
    """bench_gpt's step for ``cfg`` on ``device`` (``cuda`` unless the
    CPU is asked for): weights from ``seed``, bf16 O2 unless ``amp_o2``
    is false (f32 then), ``optimizer`` (by default ``AdamW(1e-4,
    multi_precision=True)``), the fusion pass as ``fusion`` says
    (:class:`TrainStep`), captured unless ``capture`` is false.

    With any of ``dp``, ``mp``, ``pp``, ``sharding`` or ``sep`` above 1,
    or a ``strategy`` (``fleet.DistributedStrategy``, whose
    ``hybrid_configs`` then give the degrees, ``pipeline_configs`` the
    micro-batches and virtual stages and ``sharding`` /
    ``sharding_configs`` the ZeRO level), this rank's
    :class:`HybridTrainStep`: the process group is joined
    (``init_parallel_env(device=device)``, unless the caller joined one,
    with ``backend="gloo"`` for ranks that share a card), then
    ``fleet.init``; the model is drawn whole from ``seed`` on every rank
    (the single-card step's weights), then cut to this rank's tensor-
    parallel shard and, with ``pp``, to its pipeline stage
    (``GPTForCausalLM.keep_stage``: ``virtual_stages`` a rank,
    ``microbatches`` micro-batches, ``pp`` by default); its dropout
    streams come from ``model_parallel_random_seed(seed)``.  With
    ``sharding`` the optimizer state is sharded at ``sharding_level``
    (``os``, ``os_g`` or ``p_g_os``; ``os_g`` unless the strategy or the
    optimizer says; at ``p_g_os`` the blocks are recomputed, their
    weights gathered for each pass).  With ``sep`` each rank takes its
    ``S / sep`` positions of every sequence and attention goes around the
    sep ring (with mp, sharding at every level and dp; with pp it
    raises).  The fusion pass is off
    (``fusion=True`` raises: not ported for hybrid models).  A step on
    gloo needs ``capture=False``."""
    if strategy is None and dp == mp == pp == sharding == sep == 1:
        gen = make_generator(seed, device)
        model = GPTForCausalLM(cfg, generator=gen)
        if amp_o2:
            decorate(model, level="O2", dtype="bfloat16")
        return TrainStep(model,
                         GPTPretrainingCriterion(mp_group=model.mp_group),
                         optimizer or _default_optimizer(), gen,
                         fusion=fusion, capture=capture)
    if strategy is None:
        from .distributed import fleet
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp,
                                   "pp_degree": pp,
                                   "sharding_degree": sharding,
                                   "sep_degree": sep}
        strategy.pipeline_configs = {"accumulate_steps": microbatches or 1,
                                     "virtual_pp_degree": virtual_stages}
    return _build_hybrid_step(cfg, device, seed, amp_o2, fusion, optimizer,
                              strategy, sharding_level, capture)


def _build_hybrid_step(cfg, device, seed, amp_o2, fusion, optimizer,
                       strategy, sharding_level, capture) -> HybridTrainStep:
    from .distributed import fleet, init_parallel_env, rank_device
    init_parallel_env(device=device)
    fleet.init(is_collective=True, strategy=strategy)
    _refuse_sep_in_pipeline(fleet.get_hybrid_communicate_group())
    gen = make_generator(seed, rank_device())
    model = GPTForCausalLM(cfg, generator=gen)
    return hybrid_gpt_step(model, gen, seed, strategy, amp_o2=amp_o2,
                           fusion=fusion, optimizer=optimizer,
                           sharding_level=sharding_level, capture=capture)


def _refuse_sep_in_pipeline(hcg) -> None:
    if hcg.get_sep_parallel_world_size() > 1 and \
            hcg.get_pipe_parallel_world_size() > 1:
        raise NotImplementedError(
            f"sep_degree {hcg.get_sep_parallel_world_size()} with pp_degree "
            f"{hcg.get_pipe_parallel_world_size()}: sequence parallelism "
            f"inside a pipeline is not ported (ring attention runs with dp, "
            f"mp and sharding)")


def hybrid_gpt_step(model: GPTForCausalLM, gen: torch.Generator, seed: int,
                    strategy, *, amp_o2: bool = True,
                    fusion: Optional[bool] = None,
                    optimizer: Optional[Optimizer] = None,
                    sharding_level: Optional[str] = None,
                    capture: bool = True,
                    criterion: Optional[torch.nn.Module] = None
                    ) -> HybridTrainStep:
    """This rank's :class:`HybridTrainStep` of ``model`` (a whole
    ``GPTForCausalLM`` built after ``fleet.init``, so a tensor-parallel
    shard at mp above 1, drawn from ``gen``) under fleet's topology:
    its dropout streams from ``model_parallel_random_seed(seed)``, cut to
    this rank's pipeline stage with ``pp``, O2 bf16 when ``amp_o2``, the
    optimizer state sharded at ``sharding_level`` over the sharding group
    (``os_g`` unless the strategy or the optimizer says), stage 3's
    windows stored at ``p_g_os`` (:func:`build_train_step`).  The loss is
    ``criterion``, by default the causal-LM loss over the model's mp
    group."""
    from .distributed import fleet
    from .distributed.fleet.meta_parallel import (PipelineEngine,
                                                  TensorParallel)
    from .distributed.fleet.meta_parallel.random import (
        MODEL_PARALLEL_RNG, model_parallel_random_seed)
    from .distributed.sharding import (ZeroPlan, set_zero_level,
                                       shard_parameters, zero_level)
    hcg = fleet.get_hybrid_communicate_group()
    _refuse_sep_in_pipeline(hcg)
    if criterion is None:
        criterion = GPTPretrainingCriterion(mp_group=model.mp_group)
    tracker = model_parallel_random_seed(seed, generator=gen)
    local = tracker.get(MODEL_PARALLEL_RNG)
    if local is not gen:
        model.set_attention_generator(local)
    pp = hcg.get_pipe_parallel_world_size()
    n_sh = hcg.get_sharding_parallel_world_size()
    if pp == 1 and n_sh == 1:
        if amp_o2:
            decorate(model, level="O2", dtype="bfloat16")
        if fusion:
            model = wrap(model)              # raises: not ported for mp
        return HybridTrainStep(
            fleet.distributed_model(model), criterion,
            fleet.distributed_optimizer(optimizer or _default_optimizer()),
            gen, hcg, capture=capture, generators=tracker.generators())
    if fusion:
        raise NotImplementedError("the fusion pass is not ported for "
                                  "sharded or pipelined models")
    opt = fleet.distributed_optimizer(optimizer or _default_optimizer())
    if n_sh > 1 and (sharding_level or zero_level(opt) is None):
        set_zero_level(opt, sharding_level or "os_g")
    level = zero_level(opt) if n_sh > 1 else None
    engine, v = None, 1
    if pp > 1:
        cfg_pp = strategy.pipeline_configs
        v = int(cfg_pp.get("virtual_pp_degree", 1))
        model.keep_stage(pp, hcg.get_stage_id(), v)
        engine = PipelineEngine(
            hcg, max(int(cfg_pp.get("accumulate_steps", 1)), pp), v)
    if amp_o2:
        decorate(model, level="O2", dtype="bfloat16")
    if level == "p_g_os":
        model.gpt.use_recompute = True
        shard_parameters(model, hcg)
    net = TensorParallel(model, hcg) if \
        hcg.get_model_parallel_world_size() > 1 else model
    named = dict(model.named_parameters())
    chunks = {}
    if pp > 1:
        prefixes, _ = model.pipeline_blocks()
        per = model.config.num_layers // (pp * v)
        chunks = {n: (i // per) // pp for i, pre in enumerate(prefixes)
                  for n in named if n.startswith(pre)}
    # the tied word embedding: on the first and the last stage, its
    # gradients summed over both, counted in the clip on the first
    tied = {WORD_EMBEDDING: (hcg.get_pipe_ends_group(),
                             hcg.is_first_stage())} if pp > 1 else {}
    zero = ZeroPlan(named, hcg, level, chunks=chunks, virtual_stages=v,
                    tied=tied)
    return HybridTrainStep(
        net, criterion, opt, gen, hcg, capture=capture,
        generators=tracker.generators(), zero=zero, engine=engine)


def make_batch(cfg: GPTConfig, batch: int, seq: int, seed: int = 0,
               device=None):
    """bench_gpt's fixed batch: ids, then labels, uniform over the
    vocabulary from ``np.random.RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    dev = resolve_device(device)
    ids = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int64)
    labels = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int64)
    return torch.from_numpy(ids).to(dev), torch.from_numpy(labels).to(dev)


def build_bert_pretrain_step(cfg: BertConfig, *, device=None, seed: int = 0,
                             amp_o2: bool = True,
                             fusion: Optional[bool] = None,
                             optimizer: Optional[Optimizer] = None
                             ) -> TrainStep:
    """The BERT pretraining step for ``cfg`` on ``device`` (``cuda``
    unless the CPU is asked for): weights from ``seed``, bf16 O2 unless
    ``amp_o2`` is false (f32 then), ``optimizer`` (by default
    ``AdamW(1e-4, multi_precision=True)``), the fusion pass as ``fusion``
    says (:class:`TrainStep`)."""
    gen = make_generator(seed, device)
    model = BertForPretraining(cfg, generator=gen)
    if amp_o2:
        decorate(model, level="O2", dtype="bfloat16")
    return TrainStep(model, BertPretrainingCriterion(),
                     optimizer or _default_optimizer(), gen, fusion=fusion)


def make_bert_batch(cfg: BertConfig, batch: int, seq: int, seed: int = 0,
                    device=None, *, padded: bool = False):
    """A fixed masked-LM batch from ``np.random.RandomState(seed)``:
    ``(inputs, targets)``, the keyword arguments of
    ``BertForPretraining`` and of ``BertPretrainingCriterion``.

    Ids are uniform over the vocabulary.  ``MAX_PREDICTIONS`` positions
    of each sequence are MLM targets: their labels are the original ids
    (every other label is -100), their input ids become ``MASK_TOKEN``,
    their ``masked_lm_weights`` 1 (0 elsewhere).  Token types are 0 on
    the first half of the sequence and 1 on the second; NSP labels are
    uniform in {0, 1}.  Sequences are full length with no attention mask,
    as packed pretraining data is, unless ``padded``: then each has a
    length uniform in ``[seq // 2, seq]``, a ``(B, T)`` padding mask, and
    targets only inside its length."""
    rng = np.random.RandomState(seed)
    dev = resolve_device(device)
    ids = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int64)
    lengths = (rng.randint(seq // 2, seq + 1, batch) if padded
               else np.full(batch, seq))
    labels = np.full((batch, seq), -100, np.int64)
    weights = np.zeros((batch, seq), np.float32)
    for row, n in enumerate(lengths):
        pos = rng.choice(n, min(MAX_PREDICTIONS, n), replace=False)
        labels[row, pos] = ids[row, pos]
        ids[row, pos] = MASK_TOKEN
        weights[row, pos] = 1.0
    token_types = np.zeros((batch, seq), np.int64)
    token_types[:, seq // 2:] = 1
    nsp = rng.randint(0, 2, batch).astype(np.int64)

    def t(a):
        return torch.from_numpy(a).to(dev)

    inputs = {"input_ids": t(ids), "token_type_ids": t(token_types)}
    if padded:
        inputs["attention_mask"] = t(
            (np.arange(seq)[None, :] < lengths[:, None]).astype(np.float32))
    targets = {"masked_lm_labels": t(labels),
               "next_sentence_labels": t(nsp),
               "masked_lm_weights": t(weights)}
    return inputs, targets


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.train", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", choices=sorted(CONFIGS), default="gpt_345m")
    ap.add_argument("--batch", type=int, default=None,
                    help="16 for GPT, 32 for BERT by default (the global "
                    "batch with --dp)")
    ap.add_argument("--seq", type=int, default=None,
                    help="1024 for GPT, 128 for BERT by default")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--recompute", action=argparse.BooleanOptionalAction,
                    default=True, help="GPT: recompute each block in the "
                    "backward pass (default on; bench_gpt's headline run "
                    "at batch 8 has it off)")
    ap.add_argument("--fusion", action=argparse.BooleanOptionalAction,
                    default=None, help="the fusion pass (default: on "
                    "unless PT_FUSION_PASS=0; off with --mp)")
    ap.add_argument("--dp", type=int, default=1,
                    help="GPT: data-parallel ranks")
    ap.add_argument("--mp", type=int, default=1,
                    help="GPT: tensor-parallel ranks")
    ap.add_argument("--pp", type=int, default=1,
                    help="GPT: pipeline stages")
    ap.add_argument("--sharding", type=int, default=1,
                    help="GPT: ZeRO sharding ranks")
    ap.add_argument("--sep", type=int, default=1,
                    help="GPT: sequence-parallel ranks (ring attention)")
    ap.add_argument("--sharding-level", choices=("os", "os_g", "p_g_os"),
                    default="os_g", help="with --sharding: the ZeRO level "
                    "(default os_g)")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="with --pp: micro-batches (default pp)")
    ap.add_argument("--virtual-stages", type=int, default=1,
                    help="with --pp: virtual stages a rank (interleaved "
                    "1F1B)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="with more than one rank: nccl on cards (default), "
                    "gloo on the CPU or for ranks that share a card (eager "
                    "steps)")
    return ap


def _ranks(args) -> int:
    return args.dp * args.mp * args.pp * args.sharding * args.sep


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parser().parse_args(argv)
    if _ranks(args) > 1:
        if not args.model.startswith("gpt"):
            raise SystemExit("--dp, --mp, --pp, --sharding and --sep take a "
                             "GPT model")
        launched = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        if launched > 1:
            # started by the launcher: this process is one of the ranks
            if launched != _ranks(args):
                raise SystemExit(
                    f"the launcher started {launched} ranks; --dp x --mp x "
                    f"--pp x --sharding x --sep is {_ranks(args)}")
            _cli_rank(vars(args))
            return 0
        from .distributed import spawn
        spawn(_cli_rank, args=(vars(args),), nprocs=_ranks(args))
        return 0
    return _run(args)


def _cli_rank(arg_dict: dict) -> None:
    """One rank of the CLI's hybrid run."""
    from .distributed import init_parallel_env
    args = argparse.Namespace(**arg_dict)
    init_parallel_env(args.backend, device=args.device)
    _run(args)


def _run(args) -> int:
    from .distributed import get_rank, rank_device
    hybrid = _ranks(args) > 1
    fusion = (fusion_enabled() if not hybrid else False) \
        if args.fusion is None else args.fusion
    dev = rank_device() if hybrid else resolve_device(args.device)
    family = args.model.split("_")[0]
    batch = args.batch or DEFAULT_SHAPE[family][0]
    seq = args.seq or DEFAULT_SHAPE[family][1]
    if family == "gpt":
        # bench_gpt sizes the position table to the sequence at gpt_345m
        pos = {"max_position_embeddings": seq} \
            if args.model == "gpt_345m" else {}
        cfg = CONFIGS[args.model](use_recompute=args.recompute, **pos)
        backend = None
        if hybrid:
            from .distributed import get_backend
            backend = get_backend()
        step = build_train_step(
            cfg, device=dev, fusion=fusion, dp=args.dp, mp=args.mp,
            pp=args.pp, sharding=args.sharding, sep=args.sep,
            sharding_level=args.sharding_level if args.sharding > 1
            else None, microbatches=args.microbatches,
            virtual_stages=args.virtual_stages, capture=backend != "gloo")
        inputs, targets = make_batch(cfg, batch, seq, device=dev)
        what = "recompute" if args.recompute else "no recompute"
        if hybrid:
            what += (f", dp {args.dp} x mp {args.mp} x pp {args.pp} x "
                     f"sharding {args.sharding} x sep {args.sep} over "
                     f"{backend}")
    else:
        cfg = CONFIGS[args.model]()
        step = build_bert_pretrain_step(cfg, device=dev, fusion=fusion)
        inputs, targets = make_bert_batch(cfg, batch, seq, device=dev)
        what = "MLM + NSP, no recompute"
    what += f", fusion pass {'on' if fusion else 'off'}"
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    talk = not hybrid or get_rank() == 0
    if talk:
        print(f"{args.model} on {name}: batch {batch} x seq {seq}, "
              f"{sum(p.numel() for p in step.params.values())} parameters"
              f"{' (rank 0)' if hybrid else ''}, AMP O2 bf16, AdamW(1e-4), "
              f"{what}", flush=True)
    times, losses = [], []
    for i in range(args.steps):
        t0 = time.perf_counter()
        loss = step(inputs, targets).item()   # .item() waits for the card
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        if talk:
            print(f"step {i + 1} loss {loss:.6f} {times[-1] * 1e3:.2f} ms",
                  flush=True)
    med = statistics.median(times[1:] if len(times) > 1 else times)
    stats = step.captured.stats if step.captured is not None else {
        "compiles": 0, "hits": 0, "fallback": "eager (gloo)"}
    if talk:
        print(json.dumps({"model": args.model, "device": name,
                          "batch": batch, "seq": seq, "fusion": fusion,
                          "dp": args.dp, "mp": args.mp, "pp": args.pp,
                          "sharding": args.sharding, "sep": args.sep,
                          "losses": losses,
                          "median_step_ms": med * 1e3,
                          "sequences_per_s": batch / med,
                          "tokens_per_s": batch * seq / med,
                          "compiles": stats["compiles"],
                          "hits": stats["hits"],
                          "fallback": stats["fallback"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
