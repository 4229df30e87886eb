"""Parity of the PyTorch port's GPT training step with the JAX package,
on the CPU, at a small width (2 layers, hidden 128, 4 heads, vocab 1024,
sequence 64).

The JAX model's parameters go to the port as numpy arrays through
``params_from_numpy``; both packages then run the same token ids.
Tolerances:

 - f32, dropout 0: logits, loss and every parameter's gradient within
   1e-5 (the same products, summed in another order);
 - a 4-step ``AdamW(1e-4)`` trajectory: f32 loss within 1e-5, O2 bf16
   loss within 2e-2 (bf16 rounds at other places in the two packages);
   f32 parameters after the last step within ``2 * lr``, since AdamW's
   first steps move a parameter by about ``lr * sign(g)`` and a gradient
   near 0 may take either sign in the two packages.  In bf16 such
   gradients are rounding noise at every step (the key bias's gradient is
   0 in exact arithmetic), so an f32 master may differ by up to
   ``2 * lr`` per step: all within ``2 * lr * steps``, and 99% of them
   within ``2 * lr``;
 - recompute on and off: identical loss and gradients with dropout 0.1;
 - the tree update of every optimizer (``OPTIMIZERS``: Adam and AdamW
   as before, then SGD, Momentum, Nesterov, Adagrad, Adadelta, RMSProp,
   AMSGrad, Adamax, Lamb, NAdam, RAdam with schedules, the three clips
   and the decay modes) against the JAX ``apply_gradients_tree`` given
   the schedule's value as ``lr=``: parameters within 1e-6, slots
   within 1e-5 relative.
"""
import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.distributed.fleet.meta_parallel import \
    ParallelCrossEntropy as JParallelCrossEntropy
from paddle_tpu.incubate.models import gpt as jgpt
from paddle_tpu.jit.api import functional_call
from paddle_tpu.tensor import Tensor
from paddle_tpu_torch import train
from paddle_tpu_torch.amp import decorate
from paddle_tpu_torch.distributed.fleet.meta_parallel import \
    ParallelCrossEntropy
from paddle_tpu_torch.framework.random import make_generator
from paddle_tpu_torch.incubate.models import (GPTForCausalLM,
                                              GPTPretrainingCriterion,
                                              gpt_tiny, params_from_numpy)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import fused_kernels as tfk
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt_mod
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.optimizer import AdamW

B, S, LR, STEPS = 2, 64, 1e-4, 4
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1024, (B, S)).astype(np.int32)
    labels = rng.randint(0, 1024, (B, S)).astype(np.int32)
    return ids, labels


class _Jax:
    """The JAX package's GPT and bench_gpt's step at the test width."""

    def __init__(self, o2=False):
        pt.seed(0)
        self.model = jgpt.GPTForCausalLM(
            jgpt.gpt_tiny(tensor_parallel=False, **NO_DROPOUT))
        self.f32 = {k: np.asarray(p._data)
                    for k, p in self.model.named_parameters()}
        if o2:
            pt.amp.decorate(self.model, level="O2", dtype="bfloat16")
        self.crit = jgpt.GPTPretrainingCriterion()
        self.opt = pt.optimizer.AdamW(learning_rate=LR,
                                      parameters=self.model.parameters(),
                                      multi_precision=True)
        self.params = {k: p._data for k, p in self.model.named_parameters()}

    def loss_fn(self, ids, labels):
        fwd = self.model.forward

        def loss_of(p):
            out, _ = functional_call(self.model, p, {}, (Tensor(ids),),
                                     training=True, forward_fn=fwd)
            loss = self.crit(out, Tensor(labels))
            return loss._data.astype(jnp.float32), out._data
        return loss_of

    def trajectory(self, ids, labels):
        loss_of = self.loss_fn(ids, labels)

        @jax.jit
        def step(params, state):
            (loss, _), grads = jax.value_and_grad(loss_of, has_aux=True)(
                params)
            new_p, new_s = self.opt.apply_gradients_tree(params, grads, state)
            return loss, new_p, new_s

        params, state = self.params, self.opt.init_state_tree(self.params)
        losses = []
        for _ in range(STEPS):
            loss, params, state = step(params, state)
            losses.append(float(loss))
        return losses, params, state


def _port(arrays, o2=False, **cfg):
    kw = dict(NO_DROPOUT)
    kw.update(cfg)
    model = GPTForCausalLM(gpt_tiny(**kw), generator=make_generator(0, "cpu"))
    params_from_numpy(model, arrays)
    if o2:
        decorate(model, level="O2", dtype="bfloat16")
    return model


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


@pytest.fixture(scope="module")
def jax_f32():
    return _Jax()


def test_parameter_names_and_shapes_equal_the_jax_model(jax_f32):
    model = _port(jax_f32.f32)
    named = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert named == {n: a.shape for n, a in jax_f32.f32.items()}
    assert list(named) == list(jax_f32.f32)
    assert named["gpt.layers.0.attn.qkv_proj.weight"] == (128, 384)


def test_logits_loss_and_grads_match_jax(jax_f32):
    ids, labels = _batch()
    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        jax_f32.loss_fn(ids, labels), has_aux=True))(jax_f32.params)
    model = _port(jax_f32.f32)
    logits = model(_t(ids))
    loss = GPTPretrainingCriterion()(logits, _t(labels))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=1e-5)
    assert abs(loss.item() - float(jloss)) <= 1e-5
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[name]),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def _port_trajectory(model, ids, labels):
    step = train.TrainStep(model, GPTPretrainingCriterion(),
                           AdamW(learning_rate=LR, multi_precision=True),
                           make_generator(0, "cpu"))
    losses = [step(_t(ids), _t(labels)).item() for _ in range(STEPS)]
    return losses, step


@pytest.mark.parametrize("o2", [False, True], ids=["f32", "bf16_o2"])
def test_adamw_trajectory_matches_jax(jax_f32, o2):
    ids, labels = _batch(1)
    jm = _Jax(o2=True) if o2 else jax_f32
    jlosses, jparams, jstate = jm.trajectory(ids, labels)
    losses, step = _port_trajectory(_port(jm.f32, o2=o2), ids, labels)
    np.testing.assert_allclose(losses, jlosses, atol=2e-2 if o2 else 1e-5)
    assert losses[-1] < losses[0]
    assert step.state["step"] == int(jstate["step"]) == STEPS
    within, total = 0, 0
    for name, p in step.params.items():
        want = jstate["master"][name] if o2 else jparams[name]
        got = step.state["master"][name] if o2 else p.detach()
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2 * LR * (STEPS if o2 else 1),
                                   err_msg=name)
        within += int((np.abs(got.numpy() - np.asarray(want))
                       <= 2 * LR).sum())
        total += got.numel()
        if o2:
            assert p.dtype == torch.bfloat16
            assert torch.equal(p.detach(), got.to(torch.bfloat16))
    assert within >= 0.99 * total


# every optimizer of the tree API: (JAX class, constructor keywords, the
# schedule of both packages (None: a constant 1e-3), the clip, updates).
# Adam and AdamW are the first cases (L2 weight decay 0.01, and AdamW's
# decoupled default; constant rate, no clip, 3 updates); the others rotate
# the three clips and the decay modes (a float: L2; L2Decay; L1Decay) and
# take a StepDecay, ExponentialDecay or warm-up schedule over 8 updates.
# RAdam with beta2 0.9 switches to the rectified step at its sixth update.
_SCHED = {
    "step": lambda lr: lr.StepDecay(1e-2, step_size=3, gamma=0.5),
    "exp": lambda lr: lr.ExponentialDecay(1e-2, gamma=0.8),
    "warm": lambda lr: lr.LinearWarmup(lr.CosineAnnealingDecay(
        1e-2, T_max=6), warmup_steps=3, start_lr=0.0, end_lr=1e-2),
}
_CLIP = {"global": lambda nn: nn.ClipGradByGlobalNorm(1.0),
         "norm": lambda nn: nn.ClipGradByNorm(1.0),
         "value": lambda nn: nn.ClipGradByValue(0.5)}
_DECAY = {"l1": lambda reg: reg.L1Decay(0.01),
          "l2": lambda reg: reg.L2Decay(0.01)}
OPTIMIZERS = {
    "Adam": ("Adam", {"weight_decay": 0.01}, None, None, None, 3),
    "AdamW": ("AdamW", {}, None, None, None, 3),
    "SGD": ("SGD", {}, "step", "global", "l2", 8),
    "Momentum": ("Momentum", {"momentum": 0.9}, "exp", "norm", "l1", 8),
    "Momentum_nesterov": ("Momentum", {"use_nesterov": True,
                                       "weight_decay": 0.01},
                          "step", "value", None, 8),
    "Adagrad": ("Adagrad", {"initial_accumulator_value": 0.1}, "exp",
                "global", "l2", 8),
    "Adadelta": ("Adadelta", {"learning_rate": 1.0}, None, "norm", "l1", 8),
    "RMSProp": ("RMSProp", {"centered": True, "momentum": 0.9}, "warm",
                "value", "l2", 8),
    "Adam_amsgrad": ("Adam", {"amsgrad": True}, "warm", "global", "l1", 8),
    "AdamW_clip": ("AdamW", {}, "warm", "global", None, 8),
    "Adamax": ("Adamax", {}, "step", "norm", "l2", 8),
    "Lamb": ("Lamb", {"lamb_weight_decay": 0.01}, "exp", "value", None, 8),
    "NAdam": ("NAdam", {}, "step", "global", "l1", 8),
    "RAdam": ("RAdam", {"beta2": 0.9}, "exp", "norm", "l2", 8),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_tree_matches_jax(name):
    # f32 and bf16 parameters (the latter with f32 masters) updated from
    # the same gradients; the JAX tree takes the schedule's value as lr=,
    # the port reads its learning-rate tensor, written by write_lr()
    cls, kw, sched, clip, decay, steps = OPTIMIZERS[name]
    rng = np.random.RandomState(9)
    params = {"w": rng.randn(6, 5).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(steps)]
    jkw, tkw = dict(kw), dict(kw)
    jkw.setdefault("learning_rate", 1e-3)
    tkw.setdefault("learning_rate", 1e-3)
    jsched = tsched = None
    if sched:
        jsched, tsched = _SCHED[sched](pt.optimizer.lr), \
            _SCHED[sched](topt_mod.lr)
        jkw["learning_rate"], tkw["learning_rate"] = jsched, tsched
    if clip:
        jkw["grad_clip"], tkw["grad_clip"] = _CLIP[clip](pt.nn), \
            _CLIP[clip](tnn)
    if decay:
        jkw["weight_decay"] = _DECAY[decay](pt.regularizer)
        tkw["weight_decay"] = _DECAY[decay](treg)
    jopt = getattr(pt.optimizer, cls)(
        parameters=pt.nn.Linear(2, 2).parameters(), **jkw)
    topt = getattr(topt_mod, cls)(**tkw)
    assert tuple(topt._state_slots) == tuple(jopt._state_slots)
    jp = {"w": jnp.asarray(params["w"]),
          "b": jnp.asarray(params["b"], jnp.bfloat16)}
    tp = {"w": torch.from_numpy(params["w"]),
          "b": torch.from_numpy(params["b"]).to(torch.bfloat16)}
    jstate, tstate = jopt.init_state_tree(jp), topt.init_state_tree(tp)
    if cls == "Adagrad":
        # the JAX tree starts its accumulator at 0; its eager step starts
        # it at initial_accumulator_value (_init_slot), as the port's does
        jstate["slots"]["moment"] = {
            k: v + kw["initial_accumulator_value"]
            for k, v in jstate["slots"]["moment"].items()}
    for g in grads:
        jp, jstate = jopt.apply_gradients_tree(
            jp, {"w": jnp.asarray(g["w"]),
                 "b": jnp.asarray(g["b"], jnp.bfloat16)}, jstate,
            lr=jsched() if jsched else None)
        topt.write_lr()
        topt.apply_gradients_tree(
            tp, {"w": torch.from_numpy(g["w"]),
                 "b": torch.from_numpy(g["b"]).to(torch.bfloat16)}, tstate)
        assert topt.lr_tensor.item() == np.float32(jopt.get_lr())
        if jsched:
            jsched.step()
            tsched.step()
    assert tp["b"].dtype == torch.bfloat16 and set(tstate["master"]) == {"b"}
    assert int(tstate["step"]) == int(jstate["step"]) == steps
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tstate["master"]["b"].numpy(),
                               np.asarray(jstate["master"]["b"]), rtol=0,
                               atol=1e-6)
    for slot in topt._state_slots:
        for k in ("w", "b"):
            np.testing.assert_allclose(
                tstate["slots"][slot][k].numpy(),
                np.asarray(jstate["slots"][slot][k]), rtol=1e-5, atol=1e-7,
                err_msg=f"{slot} {k}")


def test_recompute_replays_dropout_masks(jax_f32):
    ids, labels = (_t(a) for a in _batch(2))
    runs = []
    for recompute in (False, True):
        gen = make_generator(5, "cpu")
        model = _port(jax_f32.f32, hidden_dropout_prob=0.1,
                      attention_probs_dropout_prob=0.1,
                      use_recompute=recompute)
        loss = GPTPretrainingCriterion()(model(ids, generator=gen), labels)
        loss.backward()
        runs.append((loss.detach(), {n: p.grad for n, p in
                                     model.named_parameters()},
                     gen.get_state()))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    assert torch.equal(s0, s1)
    # the masks were live: without dropout the loss differs
    plain = GPTPretrainingCriterion()(_port(jax_f32.f32)(ids), labels)
    assert not torch.equal(plain.detach(), l0)


def test_layer_norm_calls_per_step_with_recompute(jax_f32, monkeypatch):
    calls = {"fwd": 0, "bwd": 0}

    def counting(kind, fn):
        def wrapped(*a):
            calls[kind] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(tfk, "layer_norm_fwd_reference",
                        counting("fwd", tfk.layer_norm_fwd_reference))
    monkeypatch.setattr(tfk, "layer_norm_bwd_reference",
                        counting("bwd", tfk.layer_norm_bwd_reference))
    ids, labels = _batch(3)
    model = _port(jax_f32.f32, use_recompute=True)
    step = train.TrainStep(model, GPTPretrainingCriterion(),
                           AdamW(learning_rate=LR), make_generator(0, "cpu"))
    step(_t(ids), _t(labels))
    layers = model.config.num_layers
    # two per block and the final one, then the blocks' again in the
    # backward pass's recompute; one backward per LayerNorm
    assert calls == {"fwd": 2 * layers + 1 + 2 * layers,
                     "bwd": 2 * layers + 1}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_jax_with_ignored_labels(dtype):
    rng = np.random.RandomState(4)
    logits = (rng.randn(2, 5, 40) * 3).astype(np.float32)
    labels = rng.randint(0, 40, (2, 5)).astype(np.int32)
    labels[0, 1] = labels[1, 4] = -100
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = JParallelCrossEntropy()(Tensor(jnp.asarray(logits, jdt)),
                                   Tensor(jnp.asarray(labels)))._data
    got = ParallelCrossEntropy()(torch.from_numpy(logits).to(
        getattr(torch, dtype)), torch.from_numpy(labels).long())
    assert got.shape == (2, 5, 1) and got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    assert got[0, 1, 0] == 0 and got[1, 4, 0] == 0


def test_dropout_needs_the_generator_and_scales_kept_values():
    x = torch.ones(4096)
    with pytest.raises(ValueError, match="generator"):
        F.dropout(x, 0.1, training=True)
    assert F.dropout(x, 0.1, training=False) is x
    y = F.dropout(x, 0.25, training=True,
                  generator=make_generator(1, "cpu"))
    kept = y[y != 0]
    assert torch.allclose(kept, torch.full_like(kept, 1 / 0.75))
    assert 0.70 < kept.numel() / x.numel() < 0.80


def test_o2_casts_every_parameter_layer_norm_included(jax_f32):
    model = decorate(_port(jax_f32.f32), level="O2", dtype="bfloat16")
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    with pytest.raises(NotImplementedError):
        decorate(model, level="O1")


def test_params_from_numpy_checks_names_and_shapes(jax_f32):
    model = _port(jax_f32.f32)
    arrays = dict(jax_f32.f32)
    arrays.pop("gpt.final_ln.bias")
    with pytest.raises(ValueError, match="gpt.final_ln.bias"):
        params_from_numpy(model, arrays)
    arrays = dict(jax_f32.f32)
    arrays["gpt.final_ln.bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(model, arrays)
    # bf16 arrays from an O2 JAX model load exactly
    jm = _Jax(o2=True)
    bf16 = {k: np.asarray(v) for k, v in jm.params.items()}
    model = params_from_numpy(decorate(_port(jax_f32.f32)), bf16)
    p = dict(model.named_parameters())["gpt.layers.0.mlp.fc2.weight"]
    np.testing.assert_array_equal(
        p.detach().float().numpy(),
        bf16["gpt.layers.0.mlp.fc2.weight"].astype(np.float32))


def test_train_cli_runs_on_the_cpu_and_defaults_to_the_card():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert train.main(["--model", "gpt_tiny", "--batch", "2", "--seq",
                           "32", "--steps", "2", "--device", "cpu"]) == 0
    lines = out.getvalue().splitlines()
    assert lines[1].startswith("step 1 loss") and len(lines) == 4
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--model", "gpt_tiny", "--steps", "1"])
