"""The port's hapi (``paddle_tpu_torch.hapi``: ``Model``, the callbacks,
``summary``, ``flops``) on the CPU, held against the JAX package's in the
same process, weights carried by name (``params_from_numpy``):

 - the JAX package's ``TestHapi`` classifier (``tests/test_vision_hapi.py``:
   Flatten, Linear 192 -> 32, ReLU, Linear 32 -> 4, ``Adam(0.01)``,
   ``CrossEntropyLoss``, ``Accuracy``) on ``FakeData`` in the same data
   order (numpy's global stream seeded alike before each ``fit``): the
   3-epoch ``fit``'s losses and accuracies, ``evaluate``'s loss and acc
   and ``predict``'s outputs within 1e-5;
 - ``gpt_tiny`` (dropout 0, f32) through ``Model.fit`` in both packages:
   losses over 4 steps within 1e-5 (``tests/test_torch_train.py``'s
   tolerance; the JAX fusion pass falls back to the unfused step on this
   jax, as its own tests run it); the port's ``fit`` losses and final
   parameters equal to ``TrainStep``'s on the same batches, bit for bit;
 - ``save(sharded=True)`` read by the JAX ``Model.load`` and the reverse
   (parameters and the optimizer tree the same bits), a
   ``CheckpointManager`` root resolved to its newest valid step;
   ``.pdparams`` both ways; ``.pdopt`` holding what the JAX package's
   holds after a fit (no moments);
 - the callbacks (``EarlyStopping``'s stop epoch, ``ReduceLROnPlateau``'s
   rates, ``ModelCheckpoint``'s files, ``LRScheduler``'s rates) against
   the JAX package's on the same logs; ``summary``'s table and counts;
   ``flops`` against the analytic ``2 * M * K * N``;
 - a mid-epoch resume: ``gpt_tiny`` at dropout 0.1 saved after step 3 of
   8 through a ``CheckpointManager`` with the DataLoader's
   ``state_dict()`` as its data state, restored into a fresh ``Model``
   (weights from another seed) and a fresh DataLoader: steps 4-8 the
   uninterrupted run's loss bits and final parameters.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.distributed.checkpoint_manager import \
    CheckpointManager as JCheckpointManager
from paddle_tpu.incubate.models import gpt as jgpt
from paddle_tpu.vision.datasets import FakeData
from paddle_tpu_torch import hapi
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.callbacks import (EarlyStopping, LRScheduler,
                                        ModelCheckpoint, ReduceLROnPlateau)
from paddle_tpu_torch.distributed import CheckpointManager
from paddle_tpu_torch.framework import io_state
from paddle_tpu_torch.framework.random import make_generator
from paddle_tpu_torch.incubate.models import (GPTForCausalLM,
                                              GPTPretrainingCriterion,
                                              gpt_tiny, params_from_numpy)
from paddle_tpu_torch.nn.initializer import XavierNormal
from paddle_tpu_torch.train import (TrainStep, restore_checkpoint,
                                    save_checkpoint)

TOL = 1e-5
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
SEQ, N_SEQ, BATCH = 32, 8, 2


class _FakeView(tio.Dataset):
    """The JAX package's ``FakeData`` samples as a port dataset."""

    def __init__(self, data):
        self.data = data

    def __getitem__(self, i):
        return self.data[i]

    def __len__(self):
        return len(self.data)


class _Tokens(tio.Dataset):
    """Sequences of ``SEQ + 1`` tokens from ``RandomState(0)``: ids
    ``[:-1]``, labels ``[1:]``."""

    def __init__(self, n=N_SEQ, vocab=1024):
        self.tokens = np.random.RandomState(0).randint(
            0, vocab, (n, SEQ + 1)).astype(np.int64)

    def __getitem__(self, i):
        return self.tokens[i, :-1], self.tokens[i, 1:]

    def __len__(self):
        return len(self.tokens)


class _JTokens(pt.io.Dataset):
    def __init__(self):
        self.tokens = _Tokens().tokens

    def __getitem__(self, i):
        return self.tokens[i, :-1], self.tokens[i, 1:]

    def __len__(self):
        return len(self.tokens)


def _recorder(base):
    """A callback class on ``base`` (either package's ``Callback``) that
    keeps each training batch's loss (read on the host) and accuracy."""
    class Losses(base):
        def __init__(self):
            super().__init__()
            self.losses, self.accs = [], []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"]))
            if "acc" in logs:
                self.accs.append(logs["acc"])
    return Losses


_Losses = _recorder(pt.callbacks.Callback)
_TLosses = _recorder(hapi.callbacks.Callback)


def _arrays(net):
    return {k: np.asarray(p._data) for k, p in net.named_parameters()}


def _jax_classifier(lr=0.01):
    pt.seed(42)
    net = pt.nn.Sequential(pt.nn.Flatten(), pt.nn.Linear(3 * 8 * 8, 32),
                           pt.nn.ReLU(), pt.nn.Linear(32, 4))
    model = pt.Model(net)
    model.prepare(optimizer=pt.optimizer.Adam(learning_rate=lr,
                                              parameters=net.parameters()),
                  loss=pt.nn.CrossEntropyLoss(),
                  metrics=pt.metric.Accuracy())
    return model


def _port_net(arrays):
    gen = make_generator(0, "cpu")
    net = torch.nn.Sequential(
        torch.nn.Flatten(), tnn.Linear(3 * 8 * 8, 32, XavierNormal(),
                                       generator=gen),
        torch.nn.ReLU(), tnn.Linear(32, 4, XavierNormal(), generator=gen))
    return params_from_numpy(net, arrays)


def _port_classifier(arrays, lr=0.01):
    net = _port_net(arrays)
    model = hapi.Model(net)
    model.prepare(optimizer=topt.Adam(learning_rate=lr,
                                      parameters=net.parameters()),
                  loss=tnn.CrossEntropyLoss(), metrics=tmetric.Accuracy())
    return model


def _port_params(model):
    return {k: v.detach().numpy().copy()
            for k, v in model.network.state_dict().items()}


# -- the classifier -----------------------------------------------------------------

@pytest.fixture(scope="module")
def classifier():
    """Both packages' classifiers after the same 3-epoch fit."""
    data = FakeData(size=64, image_shape=(3, 8, 8), num_classes=4)
    jm = _jax_classifier()
    tm = _port_classifier(_arrays(jm.network))
    jl, tl = _Losses(), _TLosses()
    np.random.seed(0)
    jm.fit(data, epochs=3, batch_size=32, verbose=0, callbacks=[jl])
    np.random.seed(0)
    tm.fit(_FakeView(data), epochs=3, batch_size=32, verbose=0,
           callbacks=[tl])
    return jm, tm, data, jl, tl


def test_classifier_fit_evaluate_predict_match_jax(classifier):
    jm, tm, data, jl, tl = classifier
    assert len(tl.losses) == 6
    np.testing.assert_allclose(tl.losses, jl.losses, atol=TOL, rtol=0)
    assert tl.accs == jl.accs
    assert tl.losses[-1] < tl.losses[0]
    jev = jm.evaluate(data, batch_size=32, verbose=0)
    tev = tm.evaluate(_FakeView(data), batch_size=32, verbose=0)
    assert tev.keys() == jev.keys() == {"loss", "acc"}
    assert abs(tev["loss"] - jev["loss"]) <= TOL
    assert abs(tev["acc"] - jev["acc"]) <= TOL
    jp = jm.predict(data, batch_size=8, stack_outputs=True)
    tp = tm.predict(_FakeView(data), batch_size=8, stack_outputs=True)
    assert tp[0].shape == (64, 4) and tp[0].dtype == np.float32
    np.testing.assert_allclose(tp[0], jp[0], atol=TOL, rtol=0)
    for name, p in tm.network.state_dict().items():
        np.testing.assert_allclose(p.numpy(),
                                   np.asarray(dict(jm.network.state_dict())
                                              [name]._data),
                                   atol=2 * 0.01, rtol=0, err_msg=name)
    stats = tm.train_step.captured.stats
    assert stats["fallback"] == "cpu" and stats["compiles"] == 0


def test_train_batch_update_false_and_eval_batch(classifier):
    _, tm, data, _, _ = classifier
    x = np.stack([data[i][0] for i in range(8)])
    y = np.stack([data[i][1] for i in range(8)])
    before = _port_params(tm)
    state = {k: v.clone() for k, v in
             tm.train_step.state["slots"]["moment1"].items()}
    step = tm.train_step.state["step"].item()
    losses, metrics = tm.train_batch([x], [y], update=False)
    assert isinstance(losses[0], hapi.LossScalar) and float(losses[0]) > 0
    assert 0.0 <= metrics[0] <= 1.0
    after = _port_params(tm)
    assert all(np.array_equal(before[k], after[k]) for k in before)
    assert all(torch.equal(state[k], v) for k, v in
               tm.train_step.state["slots"]["moment1"].items())
    assert tm.train_step.state["step"].item() == step
    loss, acc = tm.eval_batch([x], [y])
    assert isinstance(loss[0], float)
    assert tm.network.training
    (out,) = tm.predict_batch([x])
    assert out.shape == (8, 4)


def test_loss_scalar_reads_once():
    s = hapi.LossScalar(torch.tensor(2.5))
    assert s + 1 == 3.5 and 1 - s == -1.5 and s * 2 == 5.0
    assert s > 2 and s <= 2.5 and f"{s:.2f}" == "2.50" and str(s) == "2.5"
    assert s._arr is None
    assert np.asarray(s) == 2.5


def test_save_training_false_needs_jit_save(tmp_path):
    tm = _port_classifier(_arrays(_jax_classifier().network))
    with pytest.raises(NotImplementedError, match="jit.save"):
        tm.save(str(tmp_path / "m"), training=False)


# -- GPT ------------------------------------------------------------------------------

def _jax_gpt():
    pt.seed(0)
    net = jgpt.GPTForCausalLM(jgpt.gpt_tiny(tensor_parallel=False,
                                            **NO_DROPOUT))
    model = pt.Model(net)
    model.prepare(optimizer=pt.optimizer.AdamW(
        learning_rate=1e-4, parameters=net.parameters(),
        multi_precision=True), loss=jgpt.GPTPretrainingCriterion())
    return model


def _port_gpt(arrays=None, seed=0, **cfg):
    kw = dict(NO_DROPOUT)
    kw.update(cfg)
    gen = make_generator(seed, "cpu")
    net = GPTForCausalLM(gpt_tiny(**kw), generator=gen)
    if arrays is not None:
        params_from_numpy(net, arrays)
    return net, gen


def _port_gpt_model(net, gen):
    model = hapi.Model(net, generator=gen)
    model.prepare(optimizer=topt.AdamW(learning_rate=1e-4,
                                       multi_precision=True,
                                       parameters=net.parameters()),
                  loss=GPTPretrainingCriterion())
    return model


def test_gpt_fit_matches_jax_and_train_step_bits():
    jm = _jax_gpt()
    arrays = _arrays(jm.network)
    jl, tl = _Losses(), _TLosses()
    jm.fit(pt.io.DataLoader(_JTokens(), batch_size=BATCH), epochs=1,
           verbose=0, callbacks=[jl])
    net, gen = _port_gpt(arrays)
    tm = _port_gpt_model(net, gen)
    tm.fit(tio.DataLoader(_Tokens(), batch_size=BATCH), epochs=1,
           verbose=0, callbacks=[tl])
    assert len(tl.losses) == N_SEQ // BATCH == 4
    np.testing.assert_allclose(tl.losses, jl.losses, atol=TOL, rtol=0)
    # the same step, built directly, on the same batches
    net2, gen2 = _port_gpt(arrays)
    step = TrainStep(net2, GPTPretrainingCriterion(),
                     topt.AdamW(learning_rate=1e-4, multi_precision=True),
                     gen2)
    direct = [step(ids, labels).item()
              for ids, labels in tio.DataLoader(_Tokens(),
                                                batch_size=BATCH)]
    assert direct == tl.losses
    for name, p in net.named_parameters():
        assert torch.equal(p, dict(net2.named_parameters())[name]), name


def test_mid_epoch_resume_through_the_manager_is_bit_identical(tmp_path):
    """gpt_tiny at dropout 0.1, 8 steps an epoch; the loader shuffles
    from a seeded RandomState, 2 workers."""
    mgr = CheckpointManager(str(tmp_path / "ck"))

    class Tokens(_Tokens):
        """Defined here: it does not pickle, so the workers are forked
        (spawned ones import this module and the JAX package)."""

    def loader():
        ds = Tokens(n=16)
        sampler = tio.BatchSampler(sampler=tio.RandomSampler(
            ds, generator=np.random.RandomState(0)), batch_size=BATCH)
        return tio.DataLoader(ds, batch_sampler=sampler, num_workers=2)

    class SaveAt(hapi.callbacks.Callback):
        def __init__(self, data):
            super().__init__()
            self.data = data

        def on_train_batch_end(self, step, logs=None):
            if step == 2:
                save_checkpoint(mgr, 3, self.model.train_step, block=True,
                                data_state=self.data.state_dict())

    drop = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    net, gen = _port_gpt(**drop)
    model = _port_gpt_model(net, gen)
    data, full = loader(), _TLosses()
    model.fit(data, epochs=1, verbose=0, callbacks=[full, SaveAt(data)])
    assert len(full.losses) == 8
    ds = mgr.load_data_state(3)
    assert ds["delivered"] == 3 and ds["sampler"]["cursor"] == 3

    net2, gen2 = _port_gpt(seed=1, **drop)
    resumed = _port_gpt_model(net2, gen2)
    assert restore_checkpoint(mgr, resumed.train_step) == 3
    data2, rest = loader(), _TLosses()
    data2.load_state_dict(ds)
    resumed.fit(data2, epochs=1, verbose=0, callbacks=[rest])
    assert rest.losses == full.losses[3:]
    for name, p in net.named_parameters():
        assert torch.equal(p, dict(net2.named_parameters())[name]), name


# -- checkpoints across packages ------------------------------------------------------

def _x_y(n=16, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3, 8, 8).astype(np.float32),
            rng.randint(0, 4, n).astype(np.int64))


def _opt_leaves(tree):
    out = {"step": np.asarray(tree["step"])}
    for slot, d in tree["slots"].items():
        out.update({f"{slot}/{k}": np.asarray(v) for k, v in d.items()})
    return out


def test_sharded_save_crosses_both_ways(tmp_path):
    x, y = _x_y()
    jm = _jax_classifier()
    arrays = _arrays(jm.network)
    tm = _port_classifier(arrays)
    for _ in range(2):
        tm.train_batch([x], [y])
    tm.save(str(tmp_path / "port"), sharded=True)
    jm2 = _jax_classifier()
    jm2.load(str(tmp_path / "port"))
    for k, v in _port_params(tm).items():
        np.testing.assert_array_equal(np.asarray(
            dict(jm2.network.state_dict())[k]._data), v)
    want = _opt_leaves({"step": tm.train_step.state["step"].numpy(),
                        "slots": {s: {k: t.numpy() for k, t in d.items()}
                                  for s, d in
                                  tm.train_step.state["slots"].items()}})
    got = _opt_leaves(jm2._opt_state)
    assert want.keys() == got.keys() and int(got["step"]) == 2
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])

    for _ in range(3):
        jm.train_batch([x], [y])
    jm.save(str(tmp_path / "jax"), sharded=True)
    tm2 = _port_classifier(arrays)
    tm2.load(str(tmp_path / "jax"))
    for k, v in _port_params(tm2).items():
        np.testing.assert_array_equal(np.asarray(
            dict(jm.network.state_dict())[k]._data), v)
    got = _opt_leaves({"step": tm2.train_step.state["step"].numpy(),
                       "slots": {s: {k: t.numpy() for k, t in d.items()}
                                 for s, d in
                                 tm2.train_step.state["slots"].items()}})
    want = _opt_leaves(jm._opt_state)
    assert int(got["step"]) == 3
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # training goes on from the loaded state in both
    tm2.train_batch([x], [y])
    assert tm2.train_step.state["step"].item() == 4


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_load_resolves_a_manager_root(tmp_path, writer):
    jm = _jax_classifier()
    arrays = _arrays(jm.network)
    tm = _port_classifier(arrays)
    root = str(tmp_path / "root")
    params = dict(_port_params(tm))
    if writer == "port":
        mgr = CheckpointManager(root)
        mgr.save(1, {"params": {k: torch.from_numpy(v)
                                for k, v in params.items()}})
        mgr.save(2, {"params": {k: torch.from_numpy(v + 123.0)
                                for k, v in params.items()}})
    else:
        mgr = JCheckpointManager(root)
        mgr.save(1, {"params": params})
        mgr.save(2, {"params": {k: v + 123.0 for k, v in params.items()}})
    # a newer step whose file was cut short: load falls back to step 1
    d2 = mgr.step_dir(2)
    files = sorted(os.path.join(d, f) for d, _, fs in
                   os.walk(os.path.join(d2, "data")) for f in fs)
    with open(files[0], "r+b") as f:
        f.truncate(os.path.getsize(files[0]) // 2)
    with torch.no_grad():
        for p in tm.network.parameters():
            p.add_(1.0)
    tm.load(root)
    for k, v in _port_params(tm).items():
        np.testing.assert_array_equal(v, params[k])
    jm.network[1].weight._data = jm.network[1].weight._data + 1.0
    jm.load(root)
    np.testing.assert_array_equal(np.asarray(jm.network[1].weight._data),
                                  params["1.weight"])


def test_pdparams_both_ways_and_pdopt_as_the_jax_package_writes(tmp_path):
    x, y = _x_y()
    sched = dict(learning_rate=0.01, step_size=1, gamma=0.5)
    jnet = _jax_classifier().network
    arrays = _arrays(jnet)
    jm = pt.Model(jnet)
    jm.prepare(optimizer=pt.optimizer.Adam(
        learning_rate=pt.optimizer.lr.StepDecay(**sched),
        parameters=jnet.parameters()), loss=pt.nn.CrossEntropyLoss())
    net = _port_net(arrays)
    tm = hapi.Model(net)
    tm.prepare(optimizer=topt.Adam(learning_rate=topt.lr.StepDecay(**sched),
                                   parameters=net.parameters()),
               loss=tnn.CrossEntropyLoss())
    for m in (jm, tm):
        for _ in range(2):
            m.train_batch([x], [y])
        m._optimizer._learning_rate_scheduler.step()
    jm.save(str(tmp_path / "j"))
    tm.save(str(tmp_path / "t"))
    jopt = jio_load(str(tmp_path / "j.pdopt"))
    topt_ = io_state.load(str(tmp_path / "t.pdopt"))
    # the fitted model's moments live in the step's tree, not here
    sched_state = tm._optimizer._learning_rate_scheduler.state_dict()
    assert sched_state["last_lr"] == 0.005
    assert jopt == topt_ == {"global_step": 0, "LR_Scheduler": sched_state}
    t2 = _port_classifier(arrays)
    t2.load(str(tmp_path / "j"))
    for k, v in t2.network.state_dict().items():
        np.testing.assert_array_equal(
            v.numpy(), np.asarray(dict(jm.network.state_dict())[k]._data))
    j2 = _jax_classifier()
    # the JAX optimizer without a schedule cannot take a .pdopt that has
    # one (its set_state_dict makes an array of the schedule's dict)
    j2.load(str(tmp_path / "t"), reset_optimizer=True)
    for k, v in tm.network.state_dict().items():
        np.testing.assert_array_equal(
            np.asarray(dict(j2.network.state_dict())[k]._data), v.numpy())
    assert t2._optimizer.state_dict() == {"global_step": 0}


def test_pdopt_with_moments_is_refused_not_dropped(tmp_path):
    """A ``.pdopt`` that holds moments (the JAX package's eager ``step()``
    fills them) raises in the port's ``Model.load``, naming the sharded
    save, where a silent load would resume from zero moments;
    ``reset_optimizer=True`` loads the parameters alone."""
    pt.seed(3)
    jnet = pt.nn.Linear(6, 2)
    jopt = pt.optimizer.Adam(learning_rate=0.01,
                             parameters=jnet.parameters())
    x = pt.to_tensor(np.random.RandomState(0).randn(4, 6).astype(np.float32))
    (jnet(x) ** 2).mean().backward()
    jopt.step()
    saved = jopt.state_dict()
    assert any(k.endswith("_moment1") for k in saved)
    from paddle_tpu.framework.io_state import save as jsave
    jsave(jnet.state_dict(), str(tmp_path / "j.pdparams"))
    jsave(saved, str(tmp_path / "j.pdopt"))
    net = tnn.Linear(6, 2, XavierNormal(), generator=make_generator(0, "cpu"))
    tm = hapi.Model(net)
    tm.prepare(optimizer=topt.Adam(learning_rate=0.01,
                                   parameters=net.parameters()),
               loss=tnn.CrossEntropyLoss())
    with pytest.raises(ValueError, match="sharded"):
        tm.load(str(tmp_path / "j"))
    with pytest.raises(ValueError, match="moment1"):
        topt.Adam(learning_rate=0.01).set_state_dict(
            {"global_step": 1, "w_moment1": np.zeros(2, np.float32)})
    tm.load(str(tmp_path / "j"), reset_optimizer=True)
    jw = {k: np.asarray(v._data) for k, v in jnet.state_dict().items()}
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), jw[k])


def jio_load(path):
    from paddle_tpu.framework.io_state import load
    return load(path)


# -- callbacks ---------------------------------------------------------------------------

class _Holder:
    """What a callback sees of a model: ``stop_training`` and
    ``_optimizer``."""

    def __init__(self, opt=None):
        self.stop_training = False
        self._optimizer = opt


LOSSES = [1.0, 0.9, 0.95, 0.91, 0.92, 0.89, 0.93, 0.94, 0.95, 0.96]
ACCS = [0.2, 0.3, 0.31, 0.305, 0.29, 0.4, 0.39, 0.38, 0.37, 0.36]


def _stop_epoch(cb, key, values):
    cb.set_model(_Holder())
    for epoch, v in enumerate(values):
        cb.on_epoch_end(epoch, {key: v})
        if cb.model.stop_training:
            return epoch, cb.best
    return None, cb.best


@pytest.mark.parametrize("key,values,kw", [
    ("loss", LOSSES, dict(patience=2)),
    ("loss", LOSSES, dict(patience=0, mode="min")),
    ("acc", ACCS, dict(patience=1)),
    ("acc", ACCS, dict(patience=3, min_delta=0.02)),
])
def test_early_stopping_matches_jax(key, values, kw):
    got = _stop_epoch(EarlyStopping(monitor=key, **kw), key, values)
    want = _stop_epoch(pt.callbacks.EarlyStopping(monitor=key, **kw), key,
                       values)
    assert got == want and got[0] is not None


def test_reduce_lr_on_plateau_matches_jax():
    net = _port_net(_arrays(_jax_classifier().network))
    port = topt.SGD(0.1, parameters=net.parameters())
    port.init_state_tree(dict(net.named_parameters()))
    ref = pt.optimizer.SGD(0.1, parameters=[])
    rates = {}
    for name, cls, opt in (("port", ReduceLROnPlateau, port),
                           ("jax", pt.callbacks.ReduceLROnPlateau, ref)):
        cb = cls(monitor="loss", factor=0.5, patience=1, cooldown=1,
                 min_lr=0.01, verbose=0)
        cb.set_model(_Holder(opt))
        rates[name] = []
        for epoch, v in enumerate(LOSSES * 2):
            cb.on_epoch_end(epoch, {"loss": v})
            rates[name].append(opt.get_lr())
    assert rates["port"] == rates["jax"]
    assert min(rates["port"]) == 0.01
    # the new rate reached the tensor a captured step reads
    assert port.lr_tensor.item() == np.float32(port.get_lr())


def test_lr_scheduler_callback_matches_jax():
    rates = {}
    for name, cbmod, lrmod, make in (
            ("port", hapi.callbacks, topt.lr,
             lambda s: topt.SGD(s)),
            ("jax", pt.callbacks, pt.optimizer.lr,
             lambda s: pt.optimizer.SGD(s, parameters=[]))):
        opt = make(lrmod.StepDecay(0.1, step_size=2, gamma=0.5))
        by_step = cbmod.LRScheduler(by_step=True)
        by_epoch = cbmod.LRScheduler(by_step=False, by_epoch=True)
        for cb in (by_step, by_epoch):
            cb.set_model(_Holder(opt))
        rates[name] = []
        for epoch in range(3):
            for step in range(3):
                by_step.on_train_batch_end(step)
                rates[name].append(opt.get_lr())
            by_epoch.on_epoch_end(epoch)
            rates[name].append(opt.get_lr())
    assert rates["port"] == rates["jax"]


def test_model_checkpoint_writes_the_jax_files(tmp_path):
    data = FakeData(size=32, image_shape=(3, 8, 8), num_classes=4)
    jm = _jax_classifier()
    tm = _port_classifier(_arrays(jm.network))
    np.random.seed(1)
    jm.fit(data, epochs=3, batch_size=16, verbose=0, save_freq=2,
           save_dir=str(tmp_path / "j"))
    np.random.seed(1)
    tm.fit(_FakeView(data), epochs=3, batch_size=16, verbose=0,
           callbacks=[ModelCheckpoint(save_freq=2,
                                      save_dir=str(tmp_path / "t"))])
    files = sorted(os.listdir(tmp_path / "t"))
    assert files == sorted(os.listdir(tmp_path / "j")) == [
        "1.pdopt", "1.pdparams", "final.pdopt", "final.pdparams"]
    final = io_state.load(str(tmp_path / "t" / "final.pdparams"))
    for k, v in final.items():
        assert torch.equal(v, tm.network.state_dict()[k])


def test_progbar_visualdl_and_wandb(tmp_path, capsys):
    data = FakeData(size=16, image_shape=(3, 8, 8), num_classes=4)
    tm = _port_classifier(_arrays(_jax_classifier().network))
    vdl = hapi.callbacks.VisualDL(log_dir=str(tmp_path / "vdl"))
    tm.fit(_FakeView(data), epochs=2, batch_size=8, verbose=2, log_freq=1,
           callbacks=[vdl])
    out = capsys.readouterr().out
    assert "Epoch 1/2" in out and "step 1: loss:" in out
    lines = (tmp_path / "vdl" / "scalars.jsonl").read_text().splitlines()
    assert len(lines) == 4 and '"loss"' in lines[0]
    try:
        import wandb  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="wandb"):
            hapi.callbacks.WandbCallback()


# -- summary and flops -------------------------------------------------------------------

def test_summary_matches_jax(capsys):
    gen = make_generator(0, "cpu")
    net = torch.nn.Sequential(tnn.Linear(4, 8, XavierNormal(), generator=gen),
                              torch.nn.ReLU(),
                              tnn.Linear(8, 2, XavierNormal(), generator=gen))
    jnet = pt.nn.Sequential(pt.nn.Linear(4, 8), pt.nn.ReLU(),
                            pt.nn.Linear(8, 2))
    got = hapi.summary(net, (1, 4))
    port_table = capsys.readouterr().out
    want = pt.summary(jnet, (1, 4))
    jax_table = capsys.readouterr().out
    assert got == want == {"total_params": 4 * 8 + 8 + 8 * 2 + 2,
                           "trainable_params": 4 * 8 + 8 + 8 * 2 + 2}
    # the JAX package names its activation classes by their function
    assert port_table == jax_table.replace("relu   ", "ReLU   ")
    net[0].bias.requires_grad_(False)
    assert hapi.Model(net).summary((1, 4))["trainable_params"] == 58 - 8


def test_flops_counts_the_products():
    gen = make_generator(0, "cpu")
    net = torch.nn.Sequential(tnn.Linear(16, 32, XavierNormal(),
                                         generator=gen), torch.nn.ReLU(),
                              tnn.Linear(32, 8, XavierNormal(),
                                         generator=gen))
    analytic = 2 * 4 * 16 * 32 + 2 * 4 * 32 * 8
    assert hapi.flops(net, (4, 16)) == analytic
    jnet = pt.nn.Sequential(pt.nn.Linear(16, 32), pt.nn.ReLU(),
                            pt.nn.Linear(32, 8))
    jflops = pt.flops(jnet, (4, 16))
    # XLA's cost analysis also counts the bias adds and the ReLU: one
    # operation an output element each
    assert jflops == analytic + 4 * 32 + 4 * 32 + 4 * 8
