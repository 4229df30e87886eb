"""Training callbacks (the counterpart of ``paddle_tpu/hapi/callbacks.py``,
the same classes and behaviour).

A callback reads the logs that ``Model.fit`` hands it; the loss there is
a :class:`~.model.LossScalar`, which waits for the card only when a
callback reads it.  ``ReduceLROnPlateau`` sets the new rate with the
optimizer's ``set_lr``, which writes it into the rate tensor a captured
step reads at each replay.  ``VisualDL`` writes its scalars to
``scalars.jsonl`` in ``log_dir``; ``WandbCallback`` needs the ``wandb``
package and raises ``ImportError`` without it.
"""
from __future__ import annotations

import os
import time

import numpy as np

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "LRScheduler",
           "EarlyStopping", "VisualDL", "config_callbacks", "CallbackList",
           "ReduceLROnPlateau", "WandbCallback"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_begin(self, mode, logs=None):
        getattr(self, f"on_{mode}_begin", lambda l=None: None)(logs)

    def on_end(self, mode, logs=None):
        getattr(self, f"on_{mode}_end", lambda l=None: None)(logs)

    def on_batch_begin(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_begin",
                lambda s, l=None: None)(step, logs)

    def on_batch_end(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_end",
                lambda s, l=None: None)(step, logs)

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = callbacks

    def __iter__(self):
        return iter(self.callbacks)

    def _call(self, name, *args):
        for cb in self.callbacks:
            getattr(cb, name)(*args)

    def set_model(self, model):
        for cb in self.callbacks:
            cb.set_model(model)

    def set_params(self, params):
        for cb in self.callbacks:
            cb.set_params(params)

    def on_begin(self, mode, logs=None):
        self._call("on_begin", mode, logs)

    def on_end(self, mode, logs=None):
        self._call("on_end", mode, logs)

    def on_epoch_begin(self, epoch, logs=None):
        self._call("on_epoch_begin", epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        self._call("on_epoch_end", epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        self._call("on_batch_begin", mode, step, logs)

    def on_batch_end(self, mode, step, logs=None):
        self._call("on_batch_end", mode, step, logs)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self._t0 = time.time()
        self.epoch = 0

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._steps = 0
        self._epoch_t0 = time.time()
        if self.verbose:
            total = self.params.get("epochs")
            print(f"Epoch {epoch + 1}/{total}")

    def on_train_batch_end(self, step, logs=None):
        self._steps += 1
        if self.verbose > 1 and step % self.log_freq == 0:
            items = [f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                     for k, v in (logs or {}).items()
                     if k in self.params.get("metrics", []) and v is not None]
            print(f"step {step}: " + ", ".join(items))

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._epoch_t0
            items = [f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                     for k, v in (logs or {}).items()
                     if k != "batch_size" and v is not None]
            print(f"  {self._steps} steps in {dt:.1f}s - " + ", ".join(items))


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            os.makedirs(self.save_dir, exist_ok=True)
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        return opt._learning_rate_scheduler if opt is not None else None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step and self._sched() is not None:
            self._sched().step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch and self._sched() is not None:
            self._sched().step()


def _auto_mode(monitor, mode):
    if mode == "auto":
        return "max" if "acc" in monitor else "min"
    return mode


def _improved(v, best, mode, min_delta):
    if best is None:
        return True
    if mode == "min":
        return v < best - min_delta
    return v > best + min_delta


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.wait = 0
        self.best = None
        self.mode = _auto_mode(monitor, mode)

    def _better(self, v):
        return _improved(v, self.best, self.mode, self.min_delta)

    def on_epoch_end(self, epoch, logs=None):
        v = (logs or {}).get(self.monitor)
        if v is None:
            return
        if isinstance(v, (list, tuple)):
            v = v[0]
        if self._better(v):
            self.best = v
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class VisualDL(Callback):
    """Scalar logging to a jsonl file (visualdl itself is not bundled)."""

    def __init__(self, log_dir="./log"):
        super().__init__()
        self.log_dir = log_dir
        self._step = 0

    def on_train_batch_end(self, step, logs=None):
        import json
        os.makedirs(self.log_dir, exist_ok=True)
        self._step += 1
        with open(os.path.join(self.log_dir, "scalars.jsonl"), "a") as f:
            # float(v) reads hapi's LossScalar: a wait for the card each
            # batch, this logger's own cost
            f.write(json.dumps({"step": self._step,
                                **{k: float(v)
                                   for k, v in (logs or {}).items()
                                   if isinstance(v, (int, float))
                                   or hasattr(v, "__float__")}}) + "\n")


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=2, verbose=2, save_freq=1,
                     save_dir=None, metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    cbk_list = CallbackList(cbks)
    cbk_list.set_model(model)
    cbk_list.set_params({
        "batch_size": batch_size, "epochs": epochs, "steps": steps,
        "verbose": verbose, "metrics": metrics or ["loss"],
    })
    return cbk_list


class ReduceLROnPlateau(Callback):
    """Reduce the optimizer's rate when the monitored metric plateaus."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        self.monitor = monitor
        self.factor = float(factor)
        if self.factor >= 1.0:
            raise ValueError(
                "ReduceLROnPlateau does not support a factor >= 1.0")
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.mode = _auto_mode(monitor, mode)
        self.best = None
        self.wait = 0
        self.cooldown_counter = 0

    def _better(self, v):
        return _improved(v, self.best, self.mode, self.min_delta)

    def on_eval_end(self, logs=None):
        self._check(logs)

    def on_epoch_end(self, epoch, logs=None):
        self._check(logs)

    def _check(self, logs):
        logs = logs or {}
        v = logs.get(self.monitor)
        if v is None:
            return
        v = float(np.mean(v)) if np.ndim(v) else float(v)
        if self.cooldown_counter > 0:
            # patience must not advance while cooling down (Keras/ref
            # semantics) — but a genuine improvement still updates best
            self.cooldown_counter -= 1
            self.wait = 0
            if self._better(v):
                self.best = v
            return
        if self._better(v):
            self.best = v
            self.wait = 0
            return
        self.wait += 1
        if self.wait >= self.patience:
            opt = getattr(self.model, "_optimizer", None)
            if opt is None:
                return
            lr = float(opt.get_lr())
            new_lr = max(lr * self.factor, self.min_lr)
            if new_lr < lr:
                opt.set_lr(new_lr)
                if self.verbose:
                    print(f"ReduceLROnPlateau: lr {lr:.3e} -> {new_lr:.3e}")
            self.cooldown_counter = self.cooldown
            self.wait = 0


class WandbCallback(Callback):
    """Weights & Biases logger: needs the ``wandb`` package at run time;
    metric logs go to ``wandb.log`` under ``train/`` and ``eval/``."""

    def __init__(self, project=None, entity=None, name=None, dir=None,
                 mode=None, job_type=None, **kwargs):
        super().__init__()
        try:
            import wandb
        except ImportError:
            raise ImportError(
                "WandbCallback requires the wandb package; install it "
                "with: pip install wandb")
        self.wandb = wandb
        self._owns_run = wandb.run is None
        self.run = wandb.init(project=project, entity=entity, name=name,
                              dir=dir, mode=mode, job_type=job_type,
                              **kwargs) if self._owns_run else wandb.run

    def _log(self, prefix, logs):
        logs = logs or {}
        payload = {f"{prefix}/{k}": (float(np.mean(v)) if np.ndim(v)
                                     else float(v))
                   for k, v in logs.items()
                   if isinstance(v, (int, float, list, tuple, np.ndarray))}
        if payload:
            self.run.log(payload)

    def on_train_batch_end(self, step, logs=None):
        self._log("train", logs)

    def on_eval_end(self, logs=None):
        self._log("eval", logs)

    def on_train_end(self, logs=None):
        if self._owns_run:  # never finish a run the user created
            self.run.finish()
