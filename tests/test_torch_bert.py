"""Parity of the PyTorch port's BERT pretraining step (MLM + NSP) with
the JAX package, on the CPU, at ``bert_tiny`` width (2 layers, hidden
64, 2 heads, FFN 128, vocab 1024).

The JAX model's parameters go to the port as numpy arrays through
``params_from_numpy``; both packages then run the same batch
(``train.make_bert_batch``, numpy from a seed).  The JAX side takes its
XLA paths on the CPU; the port runs its kernels' plain versions (the
residual LayerNorm, the softmax cross-entropy, and from sequence 512
the flash route).  Tolerances:

 - f32, dropout 0: MLM and NSP logits, loss and every parameter's
   gradient within 1e-5 (the same products, summed in another order),
   at sequence 32 with and without a padding mask, and at 512;
 - a 4-step ``AdamW(1e-4)`` trajectory: f32 loss within 1e-5 and f32
   parameters after the last step within ``2 * lr`` (AdamW's first steps
   move a parameter by about ``lr * sign(g)``, and a gradient near 0 may
   take either sign in the two packages); O2 bf16 loss within 2e-2 (bf16
   rounds at other places in the two packages, as in
   ``test_torch_train.py``);
 - attention with a bool or an additive mask against the JAX package's
   ``scaled_dot_product_attention``: 1e-5.
"""
import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.incubate.models import bert as jbert
from paddle_tpu.jit.api import functional_call
from paddle_tpu.tensor import Tensor
from paddle_tpu_torch import train
from paddle_tpu_torch.amp import decorate
from paddle_tpu_torch.framework.random import make_generator
from paddle_tpu_torch.incubate.models import (BertForPretraining,
                                              BertPretrainingCriterion,
                                              bert_tiny, params_from_numpy)
from paddle_tpu_torch.incubate.models.bert import additive_attention_mask
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import fused_kernels as tfk
from paddle_tpu_torch.ops import pallas_ops as tpo
from paddle_tpu_torch.optimizer import AdamW

B, S, LR, STEPS = 2, 32, 1e-4, 4
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
LONG = F.FLASH_MIN_SEQ


def _cfg(seq, jax_package=False):
    cfg = (jbert.bert_tiny if jax_package else bert_tiny)(**NO_DROPOUT)
    return dataclasses.replace(cfg, max_position_embeddings=max(seq, 128))


def _batch(seq, padded=False, seed=0):
    """The port's batch (``make_bert_batch``), on the CPU, as numpy
    arrays."""
    inputs, targets = train.make_bert_batch(_cfg(seq), B, seq, seed=seed,
                                            device="cpu", padded=padded)
    return ({k: v.numpy() for k, v in inputs.items()},
            {k: v.numpy() for k, v in targets.items()})


class _Jax:
    """The JAX package's BertForPretraining and its criterion."""

    def __init__(self, seq, o2=False):
        pt.seed(0)
        self.model = jbert.BertForPretraining(_cfg(seq, jax_package=True))
        self.f32 = {k: np.asarray(p._data)
                    for k, p in self.model.named_parameters()}
        if o2:
            pt.amp.decorate(self.model, level="O2", dtype="bfloat16")
        self.crit = jbert.BertPretrainingCriterion()
        self.params = {k: p._data for k, p in self.model.named_parameters()}

    def loss_fn(self, inputs, targets):
        kw = {"token_type_ids": Tensor(jnp.asarray(
            inputs["token_type_ids"], jnp.int32))}
        if "attention_mask" in inputs:
            kw["attention_mask"] = Tensor(jnp.asarray(
                inputs["attention_mask"]))
        ids = Tensor(jnp.asarray(inputs["input_ids"], jnp.int32))
        tg = {k: Tensor(jnp.asarray(v, jnp.float32 if v.dtype == np.float32
                                    else jnp.int32))
              for k, v in targets.items()}

        def loss_of(p):
            (mlm, nsp), _ = functional_call(
                self.model, p, {}, (ids,), kw, training=True,
                forward_fn=self.model.forward)
            loss = self.crit(mlm, nsp, **tg)
            return loss._data.astype(jnp.float32), (mlm._data, nsp._data)
        return loss_of

    def trajectory(self, inputs, targets):
        loss_of = self.loss_fn(inputs, targets)
        opt = pt.optimizer.AdamW(learning_rate=LR,
                                 parameters=self.model.parameters(),
                                 multi_precision=True)

        @jax.jit
        def step(params, state):
            (loss, _), grads = jax.value_and_grad(loss_of, has_aux=True)(
                params)
            new_p, new_s = opt.apply_gradients_tree(params, grads, state)
            return loss, new_p, new_s

        params, state = self.params, opt.init_state_tree(self.params)
        losses = []
        for _ in range(STEPS):
            loss, params, state = step(params, state)
            losses.append(float(loss))
        return losses, params, state


@pytest.fixture(scope="module")
def jax_short():
    return _Jax(S)


def _port(arrays, seq, o2=False):
    model = BertForPretraining(_cfg(seq), generator=make_generator(0, "cpu"))
    params_from_numpy(model, arrays)
    if o2:
        decorate(model, level="O2", dtype="bfloat16")
    return model


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def test_parameter_names_and_shapes_equal_the_jax_model(jax_short):
    model = _port(jax_short.f32, S)
    named = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert list(named) == list(jax_short.f32)
    assert named == {n: a.shape for n, a in jax_short.f32.items()}
    assert named["mlm_bias"] == (1024,)
    assert named["bert.encoder.0.attention.qkv.weight"] == (64, 192)


@pytest.mark.parametrize("seq,padded", [(S, False), (S, True), (LONG, False)],
                         ids=["full", "padding_mask", "flash_512"])
def test_logits_loss_and_grads_match_jax(jax_short, seq, padded,
                                         monkeypatch):
    jm = jax_short if seq == S else _Jax(seq)
    inputs, targets = _batch(seq, padded)
    (jloss, (jmlm, jnsp)), jgrads = jax.jit(jax.value_and_grad(
        jm.loss_fn(inputs, targets), has_aux=True))(jm.params)

    flash = []
    real = tpo.mha_reference
    monkeypatch.setattr(tpo, "mha_reference",
                        lambda *a, **k: flash.append(1) or real(*a, **k))
    model = _port(jm.f32, seq)
    mlm, nsp = model(**_torch(inputs))
    loss = BertPretrainingCriterion()(mlm, nsp, **_torch(targets))
    loss.backward()
    # without a mask the flash route runs from 512 on, with one never
    assert len(flash) == (2 if seq >= LONG else 0)
    np.testing.assert_allclose(mlm.detach().numpy(), np.asarray(jmlm),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(nsp.detach().numpy(), np.asarray(jnsp),
                               atol=1e-5, rtol=1e-5)
    assert abs(loss.item() - float(jloss)) <= 1e-5
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[name]),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("o2", [False, True], ids=["f32", "bf16_o2"])
def test_adamw_trajectory_matches_jax(jax_short, o2):
    inputs, targets = _batch(S, seed=1)
    jm = _Jax(S, o2=True) if o2 else jax_short
    jlosses, jparams, jstate = jm.trajectory(inputs, targets)
    # the JAX side runs without its fusion pass: so does the port here
    # (tests/test_torch_fusion.py holds the step with the pass on)
    step = train.TrainStep(_port(jm.f32, S, o2=o2),
                           BertPretrainingCriterion(),
                           AdamW(learning_rate=LR, multi_precision=True),
                           make_generator(0, "cpu"), fusion=False)
    losses = [step(_torch(inputs), _torch(targets)).item()
              for _ in range(STEPS)]
    np.testing.assert_allclose(losses, jlosses, atol=2e-2 if o2 else 1e-5)
    assert losses[-1] < losses[0]
    assert step.state["step"] == int(jstate["step"]) == STEPS
    if o2:
        assert {p.dtype for p in step.params.values()} == {torch.bfloat16}
        return
    for name, p in step.params.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jparams[name]), rtol=0,
                                   atol=2 * LR, err_msg=name)


def test_kernel_calls_per_step(jax_short, monkeypatch):
    calls = {"ln_fwd": [], "ln_bwd": [], "xent_fwd": 0, "xent_bwd": 0}

    def ln(kind, fn):
        def wrapped(*a):
            calls[kind].append(len(a) > 4 and a[-1] is not None)
            return fn(*a)
        return wrapped

    def xent(kind, fn):
        def wrapped(*a):
            calls[kind] += 1
            return fn(*a)
        return wrapped

    for kind, name in (("ln_fwd", "layer_norm_fwd_reference"),
                       ("ln_bwd", "layer_norm_bwd_reference")):
        monkeypatch.setattr(tfk, name, ln(kind, getattr(tfk, name)))
    for kind, name in (("xent_fwd", "softmax_xent_fwd_reference"),
                       ("xent_bwd", "softmax_xent_bwd_reference")):
        monkeypatch.setattr(tfk, name, xent(kind, getattr(tfk, name)))
    inputs, targets = _batch(S)
    # the step as slice 4 built it, without the fusion pass (its counts
    # with the pass are in tests/test_torch_fusion.py)
    step = train.TrainStep(_port(jax_short.f32, S),
                           BertPretrainingCriterion(),
                           AdamW(learning_rate=LR), make_generator(0, "cpu"),
                           fusion=False)
    step(_torch(inputs), _torch(targets))
    layers = 2
    # the embeddings' and the MLM head's LayerNorm, then two with a
    # residual per block; one backward each; the MLM and NSP losses
    for kind in ("ln_fwd", "ln_bwd"):
        assert len(calls[kind]) == 2 * layers + 2
        assert sum(calls[kind]) == 2 * layers
    assert (calls["xent_fwd"], calls["xent_bwd"]) == (2, 2)


def test_run_encoder_recompute_replays_dropout(jax_short):
    # the recompute branch ERNIE's encoder takes (use_recompute): the same
    # loss and gradients as without it, dropout masks replayed
    inputs, targets = _batch(S, padded=True, seed=2)
    runs = []
    for recompute in (False, True):
        cfg = dataclasses.replace(_cfg(S), hidden_dropout_prob=0.1,
                                  attention_probs_dropout_prob=0.1)
        cfg.use_recompute = recompute
        model = params_from_numpy(BertForPretraining(
            cfg, generator=make_generator(0, "cpu")), jax_short.f32)
        gen = make_generator(5, "cpu")
        mlm, nsp = model(**_torch(inputs), generator=gen)
        loss = BertPretrainingCriterion()(mlm, nsp, **_torch(targets))
        loss.backward()
        runs.append((loss.detach(), {n: p.grad for n, p in
                                     model.named_parameters()}))
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


@pytest.mark.parametrize("kind", ["bool", "additive"])
def test_masked_attention_matches_jax(kind):
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(2, 9, 2, 8).astype(np.float32) for _ in range(3))
    keep = rng.rand(2, 1, 9, 9) > 0.3
    keep[..., 0] = True
    mask = keep if kind == "bool" else \
        ((keep.astype(np.float32) - 1.0) * 1e4)
    want = pt.nn.functional.scaled_dot_product_attention(
        *(Tensor(jnp.asarray(a)) for a in (q, k, v)),
        attn_mask=Tensor(jnp.asarray(mask)), training=False)._data
    got = F.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        attn_mask=torch.from_numpy(mask), training=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_a_mask_keeps_attention_off_the_flash_route(monkeypatch):
    monkeypatch.setattr(tpo, "flash_attention", lambda *a, **k: (
        _ for _ in ()).throw(AssertionError("flash with a mask")))
    x = torch.randn(1, LONG, 2, 32)
    mask = torch.ones(1, 1, 1, LONG, dtype=torch.bool)
    out = F.scaled_dot_product_attention(x, x, x, attn_mask=mask,
                                         training=False)
    assert out.shape == x.shape


def test_additive_mask_matches_jax():
    m = np.array([[1, 1, 1, 0], [1, 0, 0, 0]], np.float32)
    want = jbert.additive_attention_mask(Tensor(jnp.asarray(m)))._data
    got = additive_attention_mask(torch.from_numpy(m))
    assert got.dtype == torch.float32 and got.shape == (2, 1, 1, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert additive_attention_mask(None) is None


@pytest.mark.parametrize("padded", [False, True])
def test_make_bert_batch_follows_the_phase1_recipe(padded):
    cfg = bert_tiny()
    inputs, targets = train.make_bert_batch(cfg, 4, 64, seed=0,
                                            device="cpu", padded=padded)
    again = train.make_bert_batch(cfg, 4, 64, seed=0, device="cpu",
                                  padded=padded)
    for a, b in ((inputs, again[0]), (targets, again[1])):
        assert all(torch.equal(a[k], b[k]) for k in a)
    ids, labels = inputs["input_ids"], targets["masked_lm_labels"]
    weights = targets["masked_lm_weights"]
    target = labels != -100
    assert (target.sum(1) == train.MAX_PREDICTIONS).all()
    assert torch.equal(target, weights == 1.0) and weights.sum() == 80
    assert (ids[target] == train.MASK_TOKEN).all()
    assert ((labels[target] >= 0) & (labels[target] < cfg.vocab_size)).all()
    tt = inputs["token_type_ids"]
    assert (tt[:, :32] == 0).all() and (tt[:, 32:] == 1).all()
    assert set(targets["next_sentence_labels"].tolist()) <= {0, 1}
    assert ("attention_mask" in inputs) == padded
    if padded:
        mask = inputs["attention_mask"]
        assert mask.dtype == torch.float32 and (mask.sum(1) >= 32).all()
        assert (mask[target] == 1).all()


def test_train_cli_runs_bert_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert train.main(["--model", "bert_tiny", "--batch", "2", "--seq",
                           "32", "--steps", "2", "--device", "cpu"]) == 0
    lines = out.getvalue().splitlines()
    assert "MLM + NSP" in lines[0] and len(lines) == 4
    assert lines[1].startswith("step 1 loss")
    res = json.loads(lines[-1])
    assert res["model"] == "bert_tiny" and (res["batch"], res["seq"]) == (2,
                                                                         32)
    assert all(np.isfinite(res["losses"])) and res["sequences_per_s"] > 0
