"""The high-level ``Model`` API (the counterpart of
``paddle_tpu/hapi/model.py``): ``Model(net).prepare(optimizer, loss,
metrics).fit(data)``.

The network lives on one device, which is the model's: each batch is
copied there (batches come from the DataLoader on the CPU).  ``prepare``
builds a :class:`~..train.TrainStep` over the network and the loss, so a
training batch is one step through the fusion pass (as
``fusion_enabled()`` says, as the JAX package's hapi applies its pass)
and :func:`~..jit.capture_step`: on the card a CUDA graph replays it.
Evaluation and prediction run the same fused network in ``eval()`` mode
under ``torch.no_grad()``, through a second ``capture_step``, whose key
holds the modules' ``training`` flags, so they get their own graphs.
The dropout generator is the one given as ``generator=`` (the one the
network was built from, for a model that takes ``generator=`` in its
forward), else a new one on the network's device seeded 0.

``train_batch`` returns the loss as a :class:`LossScalar`, which waits
for the card only when it is first read: ``fit`` itself reads nothing
on the host a step (its callbacks may).

``save(path)`` writes ``.pdparams`` and ``.pdopt`` in the JAX package's
pickle format (:mod:`..framework.io_state`); ``save(path,
sharded=True)`` writes ``{"params", "opt_tree"}`` through
:func:`..distributed.checkpoint.save_sharded`, the layout the JAX
package's ``Model.load`` reads; ``load`` reads either package's, a
``CheckpointManager`` root resolving to its newest valid step, and
copies into the live tensors in place (a captured graph reads their
addresses).  As in the JAX package, the optimizer state of a fitted
model lives in the step's tree, so ``.pdopt`` holds no moments
(``Optimizer.state_dict`` reads the eager accumulators), and
``prepare``'s ``amp_configs`` is kept and not read: decorate the network
(``amp.decorate``) before ``Model(...)``.  ``save(training=False)``
needs ``jit.save``, which the port does not have yet.  With telemetry
on (:mod:`..observability`), ``fit``'s and ``evaluate``'s steps are
booked (``pt_steps_total{mode}``, ``pt_step_time_seconds``).
"""
from __future__ import annotations

import inspect
import os

import numpy as np
import torch

from ..distributed.checkpoint import copy_into, load_sharded, save_sharded
from ..distributed.checkpoint_manager import latest_checkpoint
from ..framework.io_state import load as _load
from ..framework.io_state import save as _save
from ..framework.random import make_generator
from ..jit import capture_step
from ..metric import Metric, _numpy
from ..observability.telemetry import get_telemetry
from ..ops.fusion_pass import fusion_enabled, wrap
from ..train import TrainStep
from .callbacks import config_callbacks

__all__ = ["Model", "LossScalar"]


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _unwrap(o):
    return o._sync() if isinstance(o, LossScalar) else o


class LossScalar:
    """A lazy handle over a 0-d loss tensor on the device.

    ``train_batch`` returns once the step is launched; the copy to the
    host (which waits for the card) happens at the first read:
    ``float()``, a comparison, formatting.  The value is kept, so the
    wait is paid once.  It behaves as the float it holds wherever
    ``fit`` and the callbacks use it."""

    __slots__ = ("_arr", "_val")

    def __init__(self, arr):
        self._arr = arr
        self._val = None

    def _sync(self):
        v = self._val
        if v is None:
            v = self._val = float(self._arr.item())
            self._arr = None     # the device tensor is no longer needed
        return v

    def __float__(self):
        return self._sync()

    def __repr__(self):
        return repr(self._sync())

    def __str__(self):
        return str(self._sync())

    def __format__(self, spec):
        return format(self._sync(), spec)

    def __bool__(self):
        return bool(self._sync())

    def __hash__(self):
        return hash(self._sync())

    def __eq__(self, o):
        return self._sync() == _unwrap(o)

    def __lt__(self, o):
        return self._sync() < _unwrap(o)

    def __le__(self, o):
        return self._sync() <= _unwrap(o)

    def __gt__(self, o):
        return self._sync() > _unwrap(o)

    def __ge__(self, o):
        return self._sync() >= _unwrap(o)

    def __add__(self, o):
        return self._sync() + _unwrap(o)

    __radd__ = __add__

    def __sub__(self, o):
        return self._sync() - _unwrap(o)

    def __rsub__(self, o):
        return _unwrap(o) - self._sync()

    def __mul__(self, o):
        return self._sync() * _unwrap(o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._sync() / _unwrap(o)

    def __rtruediv__(self, o):
        return _unwrap(o) / self._sync()

    def __neg__(self):
        return -self._sync()

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self._sync(), dtype=dtype)


class _EvalStep:
    """The forward (and the loss, when labels are given) of ``model`` in
    the mode it is in, under ``torch.no_grad()``: ``(loss or None,
    outputs)``."""

    def __init__(self, model, criterion, generator, takes_generator):
        self.model, self.criterion = model, criterion
        self.generator, self.takes_generator = generator, takes_generator

    def __call__(self, inputs, labels):
        kw = {"generator": self.generator} if self.takes_generator else {}
        with torch.no_grad():
            out = self.model(*inputs, **kw)
            outs = tuple(out) if isinstance(out, (list, tuple)) else (out,)
            loss = None
            if self.criterion is not None and labels:
                loss = self.criterion(*outs, *labels)
                if isinstance(loss, (list, tuple)):
                    loss = loss[0]
                loss = loss.float()
        return loss, outs


class Model:
    """``network`` with an optimizer, a loss and metrics (:meth:`prepare`),
    trained by :meth:`fit`.  ``generator``: the dropout generator (see
    the module docstring)."""

    def __init__(self, network, inputs=None, labels=None, *,
                 generator=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._generator = generator
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._amp = {}
        self._train_step = None
        self._eval_step = None
        self._fused = network
        self.stop_training = False

    @property
    def device(self) -> torch.device:
        """The device of the network's parameters (the CPU without
        any)."""
        for p in self.network.parameters():
            return p.device
        return torch.device("cpu")

    @property
    def train_step(self):
        """The :class:`~..train.TrainStep` that ``prepare`` built (None
        without an optimizer): its ``captured.stats``, and the handle for
        ``train.save_checkpoint`` / ``restore_checkpoint``."""
        return self._train_step

    # -- setup ---------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError(f"metrics must be paddle_tpu_torch.metric "
                                f"metrics, got {type(m).__name__}")
        self._amp = amp_configs or {}
        self._build_steps()
        return self

    def _build_steps(self):
        net = self.network
        if self._generator is None:
            self._generator = make_generator(0, self.device)
        if self._optimizer is not None:
            self._train_step = TrainStep(net, self._loss, self._optimizer,
                                         self._generator,
                                         outputs=bool(self._metrics))
            self._fused = self._train_step.model
            takes = self._train_step.eager.takes_generator
        else:
            self._train_step = None
            self._fused = wrap(net) if fusion_enabled() else net
            takes = "generator" in inspect.signature(net.forward).parameters
        self._takes_generator = takes
        self._eval_step = capture_step(_EvalStep(
            self._fused, self._loss, self._generator, takes))

    def _on_device(self, batch):
        dev = self.device
        return [(b if isinstance(b, torch.Tensor)
                 else torch.as_tensor(np.asarray(b))).to(dev,
                                                         non_blocking=True)
                for b in _to_list(batch)]

    def _update_metrics(self, preds, labels):
        return [m.update(m.compute(preds[0], labels[0]))
                for m in self._metrics]

    # -- single batches ------------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        """One training step on a batch: ``[loss]`` (a
        :class:`LossScalar`), and the metrics' values when there are
        metrics.  ``update=False`` runs the forward and the loss in
        training mode without touching the parameters or the optimizer's
        state (dropout still draws)."""
        inputs, labels = self._on_device(inputs), self._on_device(labels)
        if not self._fused.training:
            self._fused.train()
        if update:
            out = self._train_step(tuple(inputs), tuple(labels))
            loss, preds = out if self._metrics else (out, None)
        else:
            kw = {"generator": self._generator} \
                if self._takes_generator else {}
            with torch.no_grad():
                res = self._fused(*inputs, **kw)
                preds = tuple(res) if isinstance(res, (list, tuple)) \
                    else (res,)
                loss = self._loss(*preds, *labels).float()
        metrics_out = self._update_metrics(preds, labels)
        loss_out = [LossScalar(loss)]
        return (loss_out, metrics_out) if metrics_out else loss_out

    def _run_eval(self, inputs, labels):
        was = self._fused.training
        self._fused.eval()
        try:
            return self._eval_step(tuple(inputs), tuple(labels))
        finally:
            self._fused.train(was)

    def eval_batch(self, inputs, labels=None):
        inputs, labels = self._on_device(inputs), self._on_device(labels)
        loss, preds = self._run_eval(inputs, labels)
        metrics_out = self._update_metrics(preds, labels)
        loss_out = [float(loss.item())] if loss is not None else []
        return (loss_out, metrics_out) if metrics_out else loss_out

    def predict_batch(self, inputs):
        _, preds = self._run_eval(self._on_device(inputs), [])
        return list(preds)

    # -- loops ---------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        """Train for ``epochs`` over ``train_data`` (a Dataset, batched
        here, or any iterable of batches whose last element is the
        label).  The learning-rate schedule steps once an epoch; eval
        runs every ``eval_freq`` epochs and its logs (``eval_*``) reach
        ``on_epoch_end``; a callback may set ``stop_training``.
        ``accumulate_grad_batches`` and ``num_iters`` are accepted and
        not read, as in the JAX package."""
        from ..io import DataLoader, Dataset
        if isinstance(train_data, Dataset):
            train_loader = DataLoader(train_data, batch_size=batch_size,
                                      shuffle=shuffle, drop_last=drop_last,
                                      num_workers=num_workers)
        else:
            train_loader = train_data
        if eval_data is not None and isinstance(eval_data, Dataset):
            eval_loader = DataLoader(eval_data, batch_size=batch_size,
                                     num_workers=num_workers)
        else:
            eval_loader = eval_data
        try:
            steps = len(train_loader)
        except TypeError:
            steps = None
        cbks = config_callbacks(
            callbacks, model=self, epochs=epochs, steps=steps,
            log_freq=log_freq, save_freq=save_freq, save_dir=save_dir,
            verbose=verbose,
            metrics=["loss"] + [n for m in self._metrics
                                for n in _to_list(m.name())])
        cbks.on_begin("train")
        logs = {}
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbks.on_epoch_begin(epoch)
            logs = self._run_one_epoch(train_loader, cbks, "train")
            sched = None if self._optimizer is None else \
                self._optimizer._learning_rate_scheduler
            if sched is not None:
                sched.step()
            # eval logs join before on_epoch_end, for the callbacks that
            # watch eval_loss / eval_acc
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_loader, verbose=0)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            cbks.on_epoch_end(epoch, logs)
        cbks.on_end("train", logs)
        return self

    def _run_one_epoch(self, loader, cbks, mode):
        for m in self._metrics:
            m.reset()
        logs = {}
        names = [n for m in self._metrics for n in _to_list(m.name())]
        tel = get_telemetry()
        for step, batch in enumerate(loader):
            batch = _to_list(batch)
            # the last element of a batch is the label
            inputs, labels = batch[:-1], batch[-1:]
            if len(batch) == 1:
                inputs, labels = batch, []
            cbks.on_batch_begin(mode, step, logs)
            tok = tel.step_start()
            if mode == "train":
                out = self.train_batch(inputs, labels)
            else:
                out = self.eval_batch(inputs, labels)
            tel.step_end(tok, mode=mode, batch_size=(
                labels[0].shape[0] if labels else None))
            losses, metrics = out if isinstance(out, tuple) else (out, [])
            logs["loss"] = losses[0] if losses else None
            for n, v in zip(names, metrics):
                logs[n] = float(np.asarray(v)) if not isinstance(v, list) \
                    else [float(x) for x in v]
            logs["batch_size"] = labels[0].shape[0] if labels else None
            cbks.on_batch_end(mode, step, logs)
        return logs

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        """The mean loss over ``eval_data``'s batches and the metrics'
        accumulated values."""
        from ..io import DataLoader, Dataset
        loader = DataLoader(eval_data, batch_size=batch_size,
                            num_workers=num_workers) \
            if isinstance(eval_data, Dataset) else eval_data
        for m in self._metrics:
            m.reset()
        total_loss, n = 0.0, 0
        tel = get_telemetry()
        for batch in loader:
            batch = _to_list(batch)
            tok = tel.step_start()
            out = self.eval_batch(batch[:-1], batch[-1:])
            tel.step_end(tok, mode="eval", batch_size=batch[-1].shape[0])
            losses = out[0] if isinstance(out, tuple) else out
            if losses:
                total_loss += losses[0]
                n += 1
        logs = {"loss": total_loss / max(n, 1)}
        for m in self._metrics:
            for name, v in zip(_to_list(m.name()), _to_list(m.accumulate())):
                logs[name] = v
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        """The outputs on each batch's first element, as numpy arrays (bf16
        as f32): a list a batch, or with ``stack_outputs`` each output
        concatenated over the batches."""
        from ..io import DataLoader, Dataset
        loader = DataLoader(test_data, batch_size=batch_size,
                            num_workers=num_workers) \
            if isinstance(test_data, Dataset) else test_data
        outputs = []
        for batch in loader:
            preds = self.predict_batch(_to_list(batch)[:1])
            outputs.append([_numpy(p) for p in preds])
        if stack_outputs:
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(len(outputs[0]))]
        return outputs

    # -- io -------------------------------------------------------------------
    def save(self, path, training=True, sharded=False):
        if sharded:
            tree = {"params": dict(self.network.state_dict())}
            if training and self._train_step is not None:
                tree["opt_tree"] = self._train_step.state
            save_sharded(tree, path)
            return
        if not training:
            raise NotImplementedError(
                "Model.save(training=False) exports an inference program "
                "through jit.save, which the port does not have yet")
        _save(self.network.state_dict(), path + ".pdparams")
        if self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def _set_state_dict(self, state, skip_mismatch=False):
        """Copy ``state``'s tensors into the network's live parameters and
        buffers, cast to each one's dtype; returns (missing, unexpected)
        keys.  A shape that differs raises, unless ``skip_mismatch``."""
        own = self.network.state_dict(keep_vars=True)
        missing = [k for k in own if k not in state]
        unexpected = []
        with torch.no_grad():
            for k, v in state.items():
                if k not in own:
                    unexpected.append(k)
                    continue
                src = torch.as_tensor(v)
                if tuple(src.shape) != tuple(own[k].shape):
                    if skip_mismatch:
                        continue
                    raise ValueError(
                        f"shape mismatch for {k}: loaded "
                        f"{tuple(src.shape)} vs expected "
                        f"{tuple(own[k].shape)}")
                own[k].copy_(src)
        return missing, unexpected

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Load :meth:`save`'s files (either package's), or a sharded
        checkpoint directory (a ``CheckpointManager`` root: its newest
        valid step), in place."""
        if os.path.isdir(path):
            resolved = latest_checkpoint(path)
            if resolved is not None:
                path = resolved
            tree = load_sharded(path)
            self._set_state_dict(tree["params"], skip_mismatch)
            if not reset_optimizer and self._train_step is not None and \
                    "opt_tree" in tree:
                ts = self._train_step
                copy_into({"opt_tree": ts.state},
                          {"opt_tree": ts.full_opt_tree(tree["opt_tree"])})
            return
        state = _load(path + ".pdparams") if os.path.exists(
            path + ".pdparams") else _load(path)
        self._set_state_dict(state, skip_mismatch)
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(_load(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        from .summary import summary as _summary
        return _summary(self.network, input_size, dtypes=dtype)
