"""The strategy-driven ``Engine`` (the counterpart of
``paddle_tpu/distributed/auto_parallel/engine.py``): ``prepare``, ``fit``,
``evaluate``, ``predict``, ``save``, ``load`` and ``restore_latest`` over
the port's own training steps.

``prepare`` builds one step from the strategy and the mesh:

 - at a world of one with every degree 1, a :class:`~...train.TrainStep`
   over the model, the loss and the optimizer (captured on the card, the
   fusion pass as ``fusion_enabled()`` says, as hapi's);
 - when the mesh (``distributed.init_mesh`` / ``get_mesh``, or a
   :class:`..auto_parallel_api.ProcessMesh` whose dimensions are named
   ``dp``, ``mp``, ``pp``, ``sharding``, ``sep``) or
   ``strategy.hybrid_configs`` asks for degrees above 1, or the world has
   more than one rank (the ranks left over go to dp, as the JAX mesh
   defaults to data parallelism), ``fleet.init`` and this rank's
   :class:`~...train.HybridTrainStep`: for ``GPTForCausalLM`` through
   :func:`~...train.hybrid_gpt_step`, the cutting ``build_train_step``
   uses (mp, pp, sep, sharding, dp; a whole model at mp above 1 is first
   cut to this rank's shard); for any other model ``DataParallel``
   buckets over dp, or a ``ZeroPlan`` over the sharding group, and mp,
   pp or sep above 1 raises.  Steps on gloo run eagerly.

The strategy: ``amp`` is O2 in bf16 (``use_bf16`` false, fp16, raises:
ROADMAP Queue 1 item 9); the JAX Engine's dynamic loss scaler, which it
builds even at bf16, has no counterpart until that item, so
``use_dynamic_loss_scaling`` is not read and ``scaler`` raises.
``recompute`` sets the model's ``use_recompute``.  ``sharding`` with
``sharding_configs["stage"]`` 1, 2, 3 picks ZeRO ``os``, ``os_g``,
``p_g_os`` over a sharding degree above 1 (``os_g`` without it).

The loop follows the JAX Engine: batches are ``(inputs, labels...)``;
``fit`` keeps each epoch's last loss in its history and steps the
learning-rate schedule once an epoch; ``evaluate`` returns the loss
weighted by the batches' sizes and the metrics; ``predict`` a list of
arrays.  A ``Dataset`` is batched here, shuffled unless
``shuffle=False`` (the two packages' streams differ: parity runs pass
``shuffle=False`` or a ready loader).  Batches move to the model's
device.  A hybrid engine evaluates and predicts on every rank over the
whole batch, at dp and sharding degrees only.

``save(path)`` writes the JAX Engine's state tree, ``{"params",
"buffers", "opt": {"slots", "master", "step"}}``, plus ``rng`` (the
dropout generators, which the JAX package's templates ignore), as a
sharded checkpoint both packages read; a hybrid engine writes its
windows at the JAX layout of its mesh.  ``load(path)`` and
``restore_latest(root)`` (a ``CheckpointManager`` root) copy into the
live tensors.
"""
from __future__ import annotations

import copy
import inspect
import os

import numpy as np
import torch

from ...observability.telemetry import get_telemetry
from ..checkpoint import copy_into, load_sharded, save_sharded
from ..fleet.base.distributed_strategy import DistributedStrategy

__all__ = ["Engine", "to_static"]

#: what a dynamic loss scaler and fp16 wait for
_ITEM9 = "ROADMAP Queue 1 item 9 (amp beyond O2 bf16, GradScaler)"
_AXES = ("dp", "mp", "pp", "sharding", "sep")


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


class _Loss(torch.nn.Module):
    """The user's loss, its first output when it returns several."""

    def __init__(self, loss):
        super().__init__()
        self.loss = loss

    def forward(self, *args):
        out = self.loss(*args)
        return out[0] if isinstance(out, (list, tuple)) else out


def _engine_tree(ct: dict, buffers: dict) -> dict:
    """A step's ``checkpoint_tree()`` in the JAX Engine's layout (the
    same leaf objects)."""
    return {"params": ct["params"], "buffers": buffers,
            "opt": ct["opt_tree"], "rng": ct["rng"]}


def _step_tree(tree: dict) -> dict:
    return {"params": tree.get("params", {}),
            "opt_tree": tree.get("opt", {}), "rng": tree.get("rng")}


class Engine:
    """``Engine(model, loss, optimizer, metrics, strategy, mesh, scaler,
    cluster)`` as in the reference (module docstring).  ``generator``:
    the dropout generator (the one the model was built from), else a new
    one on the model's device seeded ``seed``, which also seeds a hybrid
    step's tensor-parallel streams."""

    def __init__(self, model=None, loss=None, optimizer=None, metrics=None,
                 strategy=None, mesh=None, scaler=None, cluster=None, *,
                 generator=None, seed: int = 0):
        if not isinstance(model, torch.nn.Module):
            raise TypeError("Engine requires a torch.nn.Module model")
        if scaler is not None:
            raise NotImplementedError(f"Engine(scaler=...): {_ITEM9}")
        self._model = model
        self._loss = loss
        self._optimizer = optimizer
        self._metrics = _to_list(metrics)
        self._strategy = strategy or DistributedStrategy()
        self._mesh = mesh
        self._cluster = cluster
        self._generator = generator
        self._seed = seed
        self._step = None
        self._eval = None
        self._strategy_applied = False
        self.history = {}

    # -- properties ------------------------------------------------------------
    @property
    def train_step(self):
        """The step ``prepare`` built (None before)."""
        return self._step

    @property
    def cluster(self):
        """The cluster model of the cost estimates, read from
        ``torch.cuda`` on first use unless one was given."""
        if self._cluster is None:
            from .cluster import Cluster
            self._cluster = Cluster.auto_detect()
        return self._cluster

    def estimate_cost(self, model_desc, cfg=None, global_batch_size=None):
        """``(seconds_per_step, memory_bytes, fits)`` of ``model_desc``
        under ``cfg`` on :attr:`cluster`
        (:func:`...cost_model.parallel_cost.predict`)."""
        from ...cost_model.parallel_cost import predict
        return predict(model_desc, cfg or {}, self.cluster,
                       global_batch_size=global_batch_size)

    @property
    def main_program(self):
        return None

    @property
    def serial_main_program(self):
        return None

    # -- the step --------------------------------------------------------------
    def _device(self) -> torch.device:
        for p in self._model.parameters():
            return p.device
        return torch.device("cpu")

    def _gen(self) -> torch.Generator:
        if self._generator is None:
            from ...framework.random import make_generator
            self._generator = make_generator(self._seed, self._device())
        return self._generator

    def _degrees(self) -> dict:
        """The degrees of the engine's mesh, else of ``hybrid_configs``
        when one is above 1, else of the global mesh; dp takes the world's
        ranks left over (``fleet.hybrid_degrees``)."""
        from ..env import get_world_size
        from ..fleet.fleet import hybrid_degrees
        from ..mesh import get_mesh
        from ..auto_parallel_api import ProcessMesh
        hc = dict(self._strategy.hybrid_configs)
        mesh = self._mesh
        if mesh is None and all(int(hc.get(f"{ax}_degree", 1)) == 1
                                for ax in _AXES):
            mesh = get_mesh(create_default=False)
        if isinstance(mesh, ProcessMesh):
            shape = dict(zip(mesh.dim_names, mesh.shape))
        else:
            shape = dict(mesh.shape) if mesh is not None else {}
        for ax in _AXES:
            if shape.get(ax, 1) > 1:
                hc[f"{ax}_degree"] = shape[ax]
        dp, pp, sh, sep, mp = hybrid_degrees(hc, get_world_size())
        return {"dp": dp, "mp": mp, "pp": pp, "sharding": sh, "sep": sep}

    def _apply_strategy(self) -> None:
        if self._strategy_applied:
            return
        s = self._strategy
        if s.amp and not s.amp_configs.get("use_bf16", True):
            raise NotImplementedError(f"strategy.amp in float16: {_ITEM9}")
        if s.recompute:
            from ..fleet.fleet import apply_recompute
            apply_recompute(self._model)
        self._strategy_applied = True

    def prepare(self, inputs_spec=None, labels_spec=None, main_program=None,
                startup_program=None, mode="train"):
        """Apply the strategy and build the training step (module
        docstring); once."""
        if self._step is not None:
            return self
        self._apply_strategy()
        if mode != "train":
            return self
        if self._optimizer is None:
            raise ValueError("Engine.fit/load require an optimizer; pass one "
                             "to Engine(..., optimizer=...)")
        if self._loss is None:
            raise ValueError("Engine.fit requires a loss")
        from ..env import get_world_size
        deg = self._degrees()
        if get_world_size() == 1 and all(d == 1 for d in deg.values()):
            from ...amp import decorate
            from ...train import TrainStep
            if self._strategy.amp:
                decorate(self._model, level="O2", dtype="bfloat16")
            self._step = TrainStep(self._model, _Loss(self._loss),
                                   self._optimizer, self._gen())
        else:
            self._step = self._hybrid_step(deg)
        return self

    def _hybrid_step(self, deg: dict):
        from ...incubate.models import (GPTForCausalLM,
                                        GPTPretrainingCriterion,
                                        params_from_numpy)
        from ...train import HybridTrainStep, hybrid_gpt_step
        from .. import fleet
        from ..collective import get_backend
        from ..parallel import init_parallel_env
        s = self._strategy
        init_parallel_env(device=self._device().type)
        strat = copy.deepcopy(s)
        strat.hybrid_configs = {f"{ax}_degree": d for ax, d in deg.items()}
        # the ZeRO level is set here (fleet's optimizer takes stages 1-2)
        strat.sharding = False
        fleet.init(is_collective=True, strategy=strat)
        hcg = fleet.get_hybrid_communicate_group()
        stage = int(s.sharding_configs.get("stage", 1))
        level = {1: "os", 2: "os_g", 3: "p_g_os"}.get(stage) \
            if s.sharding else None
        capture = get_backend() != "gloo"
        model, gen = self._model, self._gen()
        if isinstance(model, GPTForCausalLM):
            if deg["mp"] > 1 and model.mp_group is None:
                # a whole model built before fleet.init: cut to this
                # rank's tensor-parallel shard, built after it
                whole = {k: p.detach().float().cpu().numpy()
                         for k, p in model.named_parameters()}
                model = GPTForCausalLM(model.config, generator=gen)
                params_from_numpy(model, whole,
                                  mp_rank=hcg.get_model_parallel_rank(),
                                  mp_degree=deg["mp"])
                self._model = model
            loss = self._loss
            if isinstance(loss, GPTPretrainingCriterion):
                loss = GPTPretrainingCriterion(mp_group=model.mp_group)
            return hybrid_gpt_step(
                model, gen, self._seed, strat, amp_o2=bool(s.amp),
                fusion=False, optimizer=self._optimizer,
                sharding_level=level, capture=capture,
                criterion=_Loss(loss))
        if deg["mp"] > 1 or deg["pp"] > 1 or deg["sep"] > 1:
            raise NotImplementedError(
                f"Engine: mp {deg['mp']}, pp {deg['pp']}, sep {deg['sep']} "
                f"for {type(model).__name__}: the port cuts GPTForCausalLM "
                f"only (its BERT has no tensor-parallel layers); other "
                f"models take dp and sharding")
        from ...amp import decorate
        from ..sharding import ZeroPlan, set_zero_level, shard_parameters
        opt = fleet.distributed_optimizer(self._optimizer)
        if deg["sharding"] == 1:
            # dp: the DataParallel buckets (fleet applies the bf16 cast)
            return HybridTrainStep(fleet.distributed_model(model),
                                   _Loss(self._loss), opt, gen, hcg,
                                   capture=capture)
        if s.amp:
            decorate(model, level="O2", dtype="bfloat16")
        level = level or "os_g"
        set_zero_level(opt, level)
        if level == "p_g_os":
            shard_parameters(model, hcg)
        zero = ZeroPlan(dict(model.named_parameters()), hcg, level)
        return HybridTrainStep(model, _Loss(self._loss), opt, gen, hcg,
                               capture=capture, zero=zero)

    # -- training ----------------------------------------------------------------
    def _loader(self, data, batch_size, shuffle, drop_last, num_workers,
                collate_fn):
        from ...io import DataLoader, Dataset
        if data is None:
            raise ValueError("data is required")
        if isinstance(data, Dataset):
            kw = {} if collate_fn is None else {"collate_fn": collate_fn}
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              drop_last=drop_last, num_workers=num_workers,
                              **kw)
        return data

    def _split_batch(self, batch, allow_unlabeled=False):
        dev = self._device()
        batch = [(b if isinstance(b, torch.Tensor) else
                  torch.as_tensor(np.asarray(b))).to(dev, non_blocking=True)
                 for b in _to_list(batch)]
        if len(batch) < 2:
            if allow_unlabeled and batch:
                return batch[:1], []
            raise ValueError("batches must be (inputs, labels)")
        return batch[:1], batch[1:]

    def fit(self, train_data=None, valid_data=None, train_sample_split=None,
            batch_size=1, epochs=1, steps_per_epoch=None, log_freq=10,
            save_dir=None, save_freq=1, valid_freq=1, valid_sample_split=None,
            valid_steps=None, collate_fn=None, callbacks=None, verbose=1,
            shuffle=True, drop_last=True, num_workers=0):
        """Train for ``epochs`` over ``train_data`` (a Dataset, or any
        iterable of ``(inputs, labels...)`` batches); returns the history
        (``loss``: each epoch's last loss; ``val_*`` with
        ``valid_data``)."""
        from ...hapi.callbacks import config_callbacks
        from ...hapi.model import LossScalar
        self.prepare(mode="train")
        loader = self._loader(train_data, batch_size, shuffle, drop_last,
                              num_workers, collate_fn)
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        cbks = config_callbacks(
            callbacks, model=self, epochs=epochs, steps=steps,
            log_freq=log_freq, save_freq=save_freq, save_dir=save_dir,
            verbose=verbose, metrics=["loss"])
        history = {"loss": []}
        tel = get_telemetry()
        cbks.on_begin("train")
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            logs = {}
            for step_i, batch in enumerate(loader):
                if steps_per_epoch is not None and step_i >= steps_per_epoch:
                    break
                cbks.on_batch_begin("train", step_i, logs)
                x, labels = self._split_batch(batch)
                # one input and one label go as tensors (a pipeline's
                # schedule splits a tensor into micro-batches)
                tok = tel.step_start()
                logs["loss"] = LossScalar(self._step(
                    x[0], labels[0] if len(labels) == 1 else tuple(labels)))
                tel.step_end(tok, mode="train", batch_size=(
                    x[0].shape[0] if getattr(x[0], "ndim", 0) else None))
                cbks.on_batch_end("train", step_i, logs)
            if logs.get("loss") is not None:
                logs["loss"] = float(logs["loss"])
                history["loss"].append(logs["loss"])
            sched = self._optimizer._learning_rate_scheduler
            if sched is not None:
                sched.step()
            cbks.on_epoch_end(epoch, logs)
            if valid_data is not None and (epoch + 1) % valid_freq == 0:
                val = self.evaluate(valid_data, batch_size=batch_size,
                                    steps=valid_steps, verbose=0)
                for k, v in val.items():
                    history.setdefault("val_" + k, []).append(v)
        cbks.on_end("train", {})
        self.history = history
        return history

    # -- evaluation and prediction ----------------------------------------------
    def _eval_step(self):
        """The forward (and loss) in eval mode, without gradients; on the
        training step's model when there is one."""
        from ...hapi.model import _EvalStep
        from ...jit import capture_step
        from ...ops.fusion_pass import fusion_enabled, wrap
        from ..parallel import unwrap_model
        step = self._step
        if step is not None and hasattr(step, "hcg"):
            hcg = step.hcg
            if hcg.get_model_parallel_world_size() > 1 or \
                    hcg.get_pipe_parallel_world_size() > 1 or \
                    hcg.get_sep_parallel_world_size() > 1:
                raise NotImplementedError(
                    "Engine.evaluate/predict at mp, pp or sep above 1: the "
                    "outputs are split over ranks (ROADMAP Queue 1 item 4)")
        if self._eval is None:
            if step is not None:
                net = step.model
            else:
                net = wrap(self._model) if fusion_enabled() else self._model
            takes = "generator" in inspect.signature(
                unwrap_model(net).forward).parameters
            loss = None if self._loss is None else _Loss(self._loss)
            ev = _EvalStep(net, loss, self._gen(), takes)
            hybrid = step is not None and hasattr(step, "hcg")
            self._eval = (net, ev if hybrid else capture_step(ev))
        return self._eval

    def _run_eval(self, x, labels):
        from ..sharding.group_sharded import gathered
        from ..parallel import unwrap_model
        net, ev = self._eval_step()
        was = net.training
        net.eval()
        try:
            with gathered(unwrap_model(net)):
                return ev(tuple(x), tuple(labels))
        finally:
            net.train(was)

    def evaluate(self, valid_data=None, valid_sample_split=None,
                 batch_size=1, steps=None, log_freq=10, collate_fn=None,
                 callbacks=None, verbose=1, num_workers=0):
        """The loss over ``valid_data`` (each batch's weighted by its
        size) and the metrics' values."""
        self._apply_strategy()
        loader = self._loader(valid_data, batch_size, False, False,
                              num_workers, collate_fn)
        for m in self._metrics:
            m.reset()
        total, count = 0.0, 0
        for step_i, batch in enumerate(loader):
            if steps is not None and step_i >= steps:
                break
            x, labels = self._split_batch(batch)
            loss, outs = self._run_eval(x, labels)
            if loss is not None:
                bs = int(x[0].shape[0])
                total += float(loss.item()) * bs
                count += bs
            for m in self._metrics:
                m.update(m.compute(outs[0], *labels))
        out = {}
        if count:
            out["loss"] = total / count
        for m in self._metrics:
            out.update(dict(zip(_to_list(m.name()),
                                _to_list(m.accumulate()))))
        return out

    def predict(self, test_data=None, test_sample_split=None, batch_size=1,
                steps=None, collate_fn=None, callbacks=None, verbose=1,
                num_workers=0):
        """The model's output on each batch's inputs: a list of numpy
        arrays (bf16 as f32)."""
        from ...metric import _numpy
        self._apply_strategy()
        loader = self._loader(test_data, batch_size, False, False,
                              num_workers, collate_fn)
        outs = []
        for step_i, batch in enumerate(loader):
            if steps is not None and step_i >= steps:
                break
            x, _ = self._split_batch(batch, allow_unlabeled=True)
            _, preds = self._run_eval(x, [])
            outs.append(_numpy(preds[0]))
        return outs

    # -- checkpoints ---------------------------------------------------------------
    def _trees(self):
        """``(the step's checkpoint_tree(), the same in the Engine's
        layout)``."""
        from ..parallel import unwrap_model
        ct = self._step.checkpoint_tree()
        hybrid = hasattr(self._step, "hcg")
        buffers = {} if hybrid else dict(
            unwrap_model(self._model).named_buffers())
        return ct, _engine_tree(ct, buffers)

    def save(self, path, training=True):
        """The engine's state at ``path`` (module docstring); without an
        optimizer, the weights as ``path + ".pdparams"``."""
        if training and self._optimizer is not None:
            self.prepare(mode="train")
        if self._step is None:
            from ...framework.io_state import save as _save
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            _save(self._model.state_dict(), path + ".pdparams")
            return
        from ..checkpoint import ProcessGroupStore, world_size
        _, tree = self._trees()
        save_sharded(tree, path, store=ProcessGroupStore.default()
                     if world_size() > 1 else None)

    def _restore(self, tree, ct, eng) -> None:
        copy_into({"buffers": eng["buffers"]},
                  {"buffers": tree.get("buffers", {})})
        self._step.load_checkpoint_tree(_step_tree(tree), template=ct)

    def load(self, path, strict=True, load_optimizer=True):
        """Copy the checkpoint at ``path`` (either package's Engine
        state) into the engine's live tensors."""
        self.prepare(mode="train")
        ct, eng = self._trees()
        tree = load_sharded(path, self._step.checkpoint_mesh, None, eng)
        self._restore(tree, ct, eng)

    def restore_latest(self, root):
        """Resume from the newest valid checkpoint under ``root`` (a
        ``CheckpointManager`` directory of ``step_<n>`` commits,
        uncommitted or corrupt ones skipped): its step number, or None
        when there is none (the state untouched)."""
        from ..checkpoint_manager import CheckpointManager
        self.prepare(mode="train")
        ct, eng = self._trees()
        tree, n = CheckpointManager(root).restore_latest(
            eng, self._step.checkpoint_mesh)
        if n is not None:
            self._restore(tree, ct, eng)
        return n


def to_static(layer, loader=None, loss=None, optimizer=None, strategy=None):
    """``paddle.distributed.to_static``: ``layer`` as a strategy-driven
    :class:`Engine`."""
    return Engine(model=layer, loss=loss, optimizer=optimizer,
                  strategy=strategy)
