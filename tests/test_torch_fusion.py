"""The PyTorch port's fusion pass (``paddle_tpu_torch.ops.fusion_pass``)
and its block kernels' plain versions, against the JAX package on the
CPU.

The same numpy inputs (from a seed) go through the JAX functions and the
port's.  On the CPU the port's wrappers run their plain versions; the
CUDA kernels themselves are held against those on the card by
``chip_smoke.py``.  Tolerances:

 - the block kernels (LayerNorm + matmul, matmul + bias + gelu) against
   the JAX package's interpret-mode Pallas kernels, their ``jax.vjp``
   and their references: 1e-5 in f32 (sums in another order), the JAX
   tests' own ``BF16_TOL`` (``tests/test_fusion_pass.py``) in bf16;
 - gpt_tiny (no recompute) and bert_tiny with the pass on against the JAX
   models (no pass) on the same weights (``params_from_numpy``), f32,
   dropout 0: logits, loss and every gradient within 1e-5;
 - the port with the pass on against itself with the pass off, f32,
   dropout 0.1 (the same dropout draws): loss within 1e-6 relative,
   gradients within 1e-5;
 - flash attention at q_len 40, kv_len 72, D 48, causal, against the JAX
   interpret-mode kernel and its ``jax.vjp``: 1e-5.

The rewrite counts are pinned from the models' structure.  The JAX pass
itself is not the oracle: it does not run on jax 0.9.0, whose jaxprs
moved ``Literal`` and renamed ``pjit`` (ROADMAP Queue 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.incubate.models import bert as jbert
from paddle_tpu.incubate.models import gpt as jgpt
from paddle_tpu.jit.api import functional_call
from paddle_tpu.ops import fused_kernels as jfk
from paddle_tpu.ops import pallas_ops as jpo
from paddle_tpu.tensor import Tensor
from paddle_tpu_torch import train
from paddle_tpu_torch.framework.random import make_generator
from paddle_tpu_torch.incubate.models import (BertForPretraining,
                                              BertPretrainingCriterion,
                                              GPTForCausalLM,
                                              GPTPretrainingCriterion,
                                              bert_tiny, gpt_tiny,
                                              params_from_numpy)
from paddle_tpu_torch.nn import LayerNorm, Linear
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.initializer import Normal
from paddle_tpu_torch.ops import fused_kernels as tfk
from paddle_tpu_torch.ops import fusion_pass as fp
from paddle_tpu_torch.ops import pallas_ops as tpo
from paddle_tpu_torch.optimizer import AdamW
from test_torch_kernels import _cuda_like

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
TOL = {"float32": F32_TOL, "bfloat16": BF16_TOL}
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
B, S = 2, 64


@pytest.fixture(autouse=True)
def _clean_pass(monkeypatch):
    monkeypatch.delenv("PT_FUSION_PASS", raising=False)
    monkeypatch.delenv("PT_FUSION_DISABLE", raising=False)
    fp.reset_stats()
    yield
    fp.reset_stats()


def _np(a):
    return np.asarray(a, np.float32)


def _close(got, want, dtype, name=""):
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want),
                               err_msg=name, **TOL[dtype])


# -- the block kernels' plain versions -----------------------------------------

def _gemm_inputs(seed, rows=20, d=96, n=200):
    rng = np.random.RandomState(seed)
    return dict(x=(rng.randn(rows, d) * 2 + 0.5).astype(np.float32),
                r=rng.randn(rows, d).astype(np.float32),
                lw=(1 + 0.3 * rng.randn(d)).astype(np.float32),
                lb=(0.2 * rng.randn(d)).astype(np.float32),
                w=(0.05 * rng.randn(d, n)).astype(np.float32),
                b=(0.1 * rng.randn(n)).astype(np.float32),
                g=rng.randn(rows, n).astype(np.float32))


def _pick(arrays, names, keep, lib, dtype):
    """The arrays ``names`` in ``lib``'s type (None where not ``keep``)."""
    out = []
    for name, on in zip(names, keep):
        a = arrays[name] if on else None
        if a is None:
            out.append(None)
        elif lib == "jax":
            out.append(jnp.asarray(a, getattr(jnp, dtype)))
        else:
            out.append(torch.from_numpy(a).to(getattr(torch, dtype)))
    return out


LNMM_CASES = [(False, True, True, True), (True, True, True, False),
              (False, False, False, True), (True, False, True, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("res,lw,lb,mb", LNMM_CASES)
def test_ln_matmul_plain_version_matches_jax(dtype, res, lw, lb, mb):
    # d = 96 (not a multiple of 128), n = 200
    a = _gemm_inputs(1)
    names = ("x", "w", "lw", "lb", "b", "r")
    keep = (True, True, lw, lb, mb, res)
    jx, jw, jlw, jlb, jb, jr = _pick(a, names, keep, "jax", dtype)
    kernel = jfk.fused_ln_matmul(jx, jw, jlw, jlb, jb, jr, epsilon=1e-5,
                                 interpret=True)
    ref = jfk.ln_matmul_reference(jx, jw, jlw, jlb, jb, jr, 1e-5)
    args = _pick(a, names, keep, "torch", dtype)
    out = tfk.ln_matmul(*args, 1e-5)
    assert out.dtype == getattr(torch, dtype) and out.shape == (20, 200)
    assert torch.equal(out, tfk.ln_matmul_reference(*args, 1e-5))
    for want in (kernel, ref):
        _close(out, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("approximate", [True, False], ids=["tanh", "erf"])
def test_matmul_bias_gelu_plain_version_matches_jax(dtype, bias,
                                                    approximate):
    a = _gemm_inputs(2)
    keep = (True, True, bias)
    jx, jw, jb = _pick(a, ("x", "w", "b"), keep, "jax", dtype)
    kernel = jfk.fused_matmul_bias_gelu(jx, jw, jb, approximate=approximate,
                                        interpret=True)
    ref = jfk.matmul_bias_gelu_reference(jx, jw, jb, approximate)
    x, w, b = _pick(a, ("x", "w", "b"), keep, "torch", dtype)
    y, z = tfk.matmul_bias_gelu(x, w, b, approximate)
    assert y.dtype == z.dtype == x.dtype and y.shape == z.shape == (20, 200)
    for want in (kernel, ref):
        _close(y, want, dtype)
    # z is the pre-activation the backward reads, in x's dtype
    zf = jnp.dot(jx, jw, preferred_element_type=jnp.float32)
    if bias:
        zf = zf + jb.astype(jnp.float32)
    _close(z, zf.astype(jx.dtype), dtype)


@pytest.mark.parametrize("res", [False, True], ids=["plain", "residual"])
def test_ln_matmul_grads_match_jax_vjp(res):
    a = _gemm_inputs(3)
    names = ("x", "w", "lw", "lb", "b") + (("r",) if res else ())
    jargs = [jnp.asarray(a[n]) for n in names]
    jy, vjp = jax.vjp(lambda *t: jfk.fused_ln_matmul(*t, interpret=True),
                      *jargs)
    jgrads = vjp(jnp.asarray(a["g"]))
    targs = [torch.from_numpy(a[n]).requires_grad_() for n in names]
    y = tfk.fused_ln_matmul(*targs, epsilon=1e-5)
    y.backward(torch.from_numpy(a["g"]))
    _close(y, jy, "float32")
    for name, t, want in zip(names, targs, jgrads):
        _close(t.grad, want, "float32", name)


@pytest.mark.parametrize("approximate", [True, False], ids=["tanh", "erf"])
def test_matmul_bias_gelu_grads_match_jax_vjp(approximate):
    a = _gemm_inputs(4)
    names = ("x", "w", "b")
    jy, vjp = jax.vjp(lambda *t: jfk.fused_matmul_bias_gelu(
        *t, approximate=approximate, interpret=True),
        *(jnp.asarray(a[n]) for n in names))
    jgrads = vjp(jnp.asarray(a["g"]))
    targs = [torch.from_numpy(a[n]).requires_grad_() for n in names]
    y = tfk.fused_matmul_bias_gelu(*targs, approximate=approximate)
    y.backward(torch.from_numpy(a["g"]))
    _close(y, jy, "float32")
    for name, t, want in zip(names, targs, jgrads):
        _close(t.grad, want, "float32", name)


def test_ln_matmul_reads_a_transposed_weight_and_recomputes_with_row_7(
        monkeypatch):
    # BERT's tied decoder: the word table's transposed view, never copied;
    # the backward recomputes h through the LayerNorm forward (row 7) and
    # finishes with its backward (row 8)
    a = _gemm_inputs(5)
    calls = []
    for name in ("layer_norm_fwd_reference", "layer_norm_bwd_reference"):
        fn = getattr(tfk, name)
        monkeypatch.setattr(tfk, name, lambda *t, _n=name, _f=fn: (
            calls.append(_n), _f(*t))[1])
    table = torch.from_numpy(np.ascontiguousarray(a["w"].T)
                             ).requires_grad_()
    x = torch.from_numpy(a["x"]).requires_grad_()
    y = tfk.fused_ln_matmul(x, table.t(), epsilon=1e-12)
    y.backward(torch.from_numpy(a["g"]))
    assert calls == ["layer_norm_fwd_reference", "layer_norm_bwd_reference"]
    want = tfk.ln_matmul_reference(x.detach(),
                                   table.detach().t().contiguous(),
                                   epsilon=1e-12)
    torch.testing.assert_close(y.detach(), want, rtol=1e-6, atol=1e-6)
    assert table.grad.shape == table.shape


# -- the pass's matches on the port's models -------------------------------------

def _gpt(recompute=False, dropout=0.1, layers=2):
    cfg = dataclasses.replace(
        gpt_tiny(use_recompute=recompute, hidden_dropout_prob=dropout,
                 attention_probs_dropout_prob=dropout), num_layers=layers)
    return GPTForCausalLM(cfg, generator=make_generator(0, "cpu")).train()


def _bert(dropout=0.1, layers=2):
    cfg = dataclasses.replace(
        bert_tiny(hidden_dropout_prob=dropout,
                  attention_probs_dropout_prob=dropout), num_layers=layers)
    return BertForPretraining(cfg, generator=make_generator(0, "cpu")).train()


def _ids(vocab=1024, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, vocab, (B, S))).long()


@pytest.mark.parametrize("layers", [2, 3])
def test_pass_counts_on_gpt_follow_the_blocks(layers):
    gen = make_generator(0, "cpu")
    # no recompute: ln1 + qkv per block; fc1 + gelu per block, which
    # leaves ln2 bare; the final LayerNorm absorbs the last residual add;
    # the tied head is torch.matmul, never a Linear
    assert fp.count_patterns(_gpt(layers=layers), _ids(), generator=gen) == {
        "ln_matmul": layers, "matmul_bias_gelu": layers,
        "layer_norm": layers, "residual_ln": 1}
    # at dropout 0 the attention clusters are rewritten too
    assert fp.count_patterns(_gpt(dropout=0.0, layers=layers), _ids(),
                             generator=gen)["attention_block"] == layers
    # a recomputed block is one opaque call: only the final LayerNorm
    assert fp.count_patterns(_gpt(recompute=True, layers=layers), _ids(),
                             generator=gen) == {"layer_norm": 1}


@pytest.mark.parametrize("layers", [2, 3])
def test_pass_counts_on_bert_follow_the_blocks(layers):
    gen = make_generator(0, "cpu")
    model = _bert(layers=layers)
    inputs, _ = train.make_bert_batch(model.config, B, S, device="cpu")
    # post-LN blocks: two residual LayerNorms each (ln1 feeds fc1 AND ln2,
    # so no ln_matmul); fc1 + gelu per block and the MLM transform; the
    # MLM LayerNorm feeds the tied decoder (F.linear of a transposed
    # view); the embeddings' sum feeds only their LayerNorm
    want = {"residual_ln": 2 * layers + 1, "matmul_bias_gelu": layers + 1,
            "ln_matmul": 1}
    assert fp.count_patterns(model, **inputs, generator=gen) == want
    # a padding mask keeps the attention cluster off at dropout 0 too
    model = _bert(dropout=0.0, layers=layers)
    assert fp.count_patterns(model, **inputs, generator=gen) == dict(
        want, attention_block=layers)
    padded, _ = train.make_bert_batch(model.config, B, S, device="cpu",
                                      padded=True)
    assert fp.count_patterns(model, **padded, generator=gen) == want


def test_absorbed_add_with_a_broadcast_addend_adds_first(monkeypatch):
    # without token types the embeddings add a (1, T, H) term: the
    # cluster then sums first and normalizes without a residual
    residuals = []
    fn = tfk.layer_norm_fwd_reference
    monkeypatch.setattr(tfk, "layer_norm_fwd_reference", lambda *a: (
        residuals.append(a[4] is not None), fn(*a))[1])
    model = _bert(dropout=0.0)
    ids = _ids()
    want = model(ids)[0]
    residuals.clear()
    got = fp.wrap(model)(ids)[0]
    assert residuals[0] is False and sum(residuals) == 4
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# -- the matcher on small modules of the port ------------------------------------

def _linear(n_in, n_out, seed=0):
    return Linear(n_in, n_out, Normal(std=0.2),
                  generator=make_generator(seed, "cpu"))


class _LnLinear(torch.nn.Module):
    def __init__(self, escape=False):
        super().__init__()
        self.ln = LayerNorm(16, generator=make_generator(0, "cpu"))
        self.lin = _linear(16, 24)
        self.escape = escape

    def forward(self, x):
        h = self.ln(x)
        y = self.lin(h)
        return (y, h) if self.escape else y


class _Mlp(torch.nn.Module):
    """LayerNorm, fc1, gelu: the gelu cluster claims fc1 first."""

    def __init__(self, approximate=True, escape=False):
        super().__init__()
        self.ln = LayerNorm(16, generator=make_generator(0, "cpu"))
        self.fc1 = _linear(16, 32)
        self.approximate, self.escape = approximate, escape

    def forward(self, x):
        z = self.fc1(self.ln(x))
        y = F.gelu(z, approximate=self.approximate)
        return (y, z) if self.escape else y


class _AddLn(torch.nn.Module):
    def __init__(self, escape=False):
        super().__init__()
        self.ln = LayerNorm(16, generator=make_generator(0, "cpu"))
        self.escape = escape

    def forward(self, a, b):
        s = a + b
        y = self.ln(s)
        return y + s if self.escape else y


class _Attention(torch.nn.Module):
    def __init__(self, dropout_p):
        super().__init__()
        self.p = dropout_p

    def forward(self, q, mask=None, generator=None):
        return F.scaled_dot_product_attention(
            q, q, q, attn_mask=mask, dropout_p=self.p, is_causal=True,
            training=self.training, generator=generator)


def _x(*shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape)
                            .astype(np.float32))


@pytest.mark.parametrize("module,args,want", [
    (_LnLinear(), (_x(3, 16),), {"ln_matmul": 1}),
    (_LnLinear(escape=True), (_x(3, 16),), {"layer_norm": 1}),
    (_Mlp(), (_x(3, 16),), {"matmul_bias_gelu": 1, "layer_norm": 1}),
    (_Mlp(approximate=False), (_x(3, 16),),
     {"matmul_bias_gelu": 1, "layer_norm": 1}),
    (_Mlp(escape=True), (_x(3, 16),), {"ln_matmul": 1}),
    (_AddLn(), (_x(3, 16), _x(3, 16, seed=1)), {"residual_ln": 1}),
    (_AddLn(escape=True), (_x(3, 16), _x(3, 16, seed=1)), {"layer_norm": 1}),
], ids=["ln_matmul", "escaping_ln", "gelu_claims_fc1", "gelu_erf",
        "escaping_pre_activation", "absorbed_add", "escaping_add"])
def test_matcher_cases(module, args, want):
    assert fp.count_patterns(module, *args) == want
    # the rewritten module computes the module's function
    out, got = module(*args), fp.wrap(module)(*args)
    for o, g in zip(out if isinstance(out, tuple) else (out,),
                    got if isinstance(got, tuple) else (got,)):
        torch.testing.assert_close(g, o, rtol=1e-5, atol=1e-5)
    assert fp.summary()["rewrites"] == want


def test_attention_cluster_only_without_mask_or_active_dropout():
    q = _x(2, 8, 2, 16)
    mask = torch.ones(8, 8, dtype=torch.bool)
    gen = make_generator(0, "cpu")
    assert fp.count_patterns(_Attention(0.0), q) == {"attention_block": 1}
    assert fp.count_patterns(_Attention(0.1).train(), q,
                             generator=gen) == {}
    assert fp.count_patterns(_Attention(0.1).eval(), q) == {
        "attention_block": 1}
    assert fp.count_patterns(_Attention(0.0), q, mask) == {}
    # the flash route at every length computes the plain attention
    torch.testing.assert_close(fp.wrap(_Attention(0.0))(q),
                               _Attention(0.0)(q), rtol=1e-5, atol=1e-5)


def test_kill_switch_and_opt_out(monkeypatch):
    module, x = _Mlp(), _x(3, 16)
    monkeypatch.setenv("PT_FUSION_DISABLE", "matmul_bias_gelu, layer_norm")
    assert fp.disabled_patterns() == {"matmul_bias_gelu", "layer_norm"}
    assert fp.count_patterns(module, x) == {"ln_matmul": 1}
    wrapped = fp.wrap(module)
    wrapped(x)
    assert fp.summary()["rewrites"] == {"ln_matmul": 1}
    monkeypatch.setenv("PT_FUSION_PASS", "0")
    assert not fp.fusion_enabled()
    fp.reset_stats()
    torch.testing.assert_close(wrapped(x), module(x), rtol=0, atol=0)
    assert fp.summary() == {"rewrites": {}, "fallbacks": {}, "traces": 0}


def test_summary_counts_rewrites_once_per_traced_graph():
    wrapped = fp.wrap(_Mlp())
    for _ in range(3):
        wrapped(_x(3, 16))
    assert fp.summary() == {"rewrites": {"matmul_bias_gelu": 1,
                                         "layer_norm": 1},
                            "fallbacks": {}, "traces": 1}
    wrapped.eval()(_x(3, 16))        # another mode is another graph
    assert fp.summary()["traces"] == 2
    assert fp.summary()["rewrites"]["layer_norm"] == 2


def test_wrap_keeps_parameters_names_and_state():
    model = _gpt()
    wrapped = fp.wrap(model)
    assert [(n, id(p)) for n, p in wrapped.named_parameters()] == [
        (n, id(p)) for n, p in model.named_parameters()]
    assert list(wrapped.state_dict()) == list(model.state_dict())
    wrapped.eval()
    assert not model.training and not model.gpt.layers[0].training
    step = train.TrainStep(model, GPTPretrainingCriterion(), AdamW(),
                           make_generator(0, "cpu"))
    assert isinstance(step.model, fp.FusedModule) and model.training
    assert list(step.params) == [n for n, _ in model.named_parameters()]
    assert not isinstance(train.TrainStep(
        _gpt(), GPTPretrainingCriterion(), AdamW(), make_generator(0, "cpu"),
        fusion=False).model, fp.FusedModule)


def test_a_failed_trace_raises_with_the_pass_on():
    class DataDependent(torch.nn.Module):
        def forward(self, x):
            return x if x.sum() > 0 else -x

    with pytest.raises(torch.fx.proxy.TraceError):
        fp.wrap(DataDependent())(_x(3, 4))


# -- the models with the pass on, against the JAX models ---------------------------

def _jax_grads(loss_of, params):
    (loss, out), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        params)
    return loss, out, grads


def _assert_like_jax(model, outs, loss, jouts, jloss, jgrads):
    for o, jo in zip(outs, jouts):
        np.testing.assert_allclose(o.detach().numpy(), _np(jo), **F32_TOL)
    assert abs(loss.item() - float(jloss)) <= 1e-5
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(jgrads[name]),
                                   err_msg=name, **F32_TOL)


def test_gpt_with_the_pass_matches_jax():
    pt.seed(0)
    jmodel = jgpt.GPTForCausalLM(jgpt.gpt_tiny(tensor_parallel=False,
                                               **NO_DROPOUT))
    params = {k: p._data for k, p in jmodel.named_parameters()}
    crit = jgpt.GPTPretrainingCriterion()
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 1024, (B, S)).astype(np.int32)
    labels = rng.randint(0, 1024, (B, S)).astype(np.int32)

    def loss_of(p):
        out, _ = functional_call(jmodel, p, {}, (Tensor(ids),),
                                 training=True, forward_fn=jmodel.forward)
        return crit(out, Tensor(labels))._data.astype(jnp.float32), \
            out._data

    jloss, jlogits, jgrads = _jax_grads(loss_of, params)
    model = _gpt(dropout=0.0)
    params_from_numpy(model, {k: np.asarray(v) for k, v in params.items()})
    logits = fp.wrap(model)(torch.from_numpy(ids).long())
    loss = GPTPretrainingCriterion()(logits, torch.from_numpy(labels).long())
    loss.backward()
    assert fp.summary()["rewrites"]["ln_matmul"] == 2
    _assert_like_jax(model, (logits,), loss, (jlogits,), jloss, jgrads)


def test_bert_with_the_pass_matches_jax():
    pt.seed(0)
    cfg = jbert.bert_tiny(**NO_DROPOUT)
    jmodel = jbert.BertForPretraining(cfg)
    params = {k: p._data for k, p in jmodel.named_parameters()}
    crit = jbert.BertPretrainingCriterion()
    inputs, targets = train.make_bert_batch(bert_tiny(), B, S, device="cpu")
    jin = {k: Tensor(jnp.asarray(v.numpy(), jnp.int32))
           for k, v in inputs.items()}
    jtg = {k: Tensor(jnp.asarray(v.numpy(), jnp.float32 if v.is_floating_point()
                                 else jnp.int32))
           for k, v in targets.items()}

    def loss_of(p):
        (mlm, nsp), _ = functional_call(
            jmodel, p, {}, (jin["input_ids"],),
            {"token_type_ids": jin["token_type_ids"]}, training=True,
            forward_fn=jmodel.forward)
        return crit(mlm, nsp, **jtg)._data.astype(jnp.float32), \
            (mlm._data, nsp._data)

    jloss, jouts, jgrads = _jax_grads(loss_of, params)
    model = _bert(dropout=0.0)
    params_from_numpy(model, {k: np.asarray(v) for k, v in params.items()})
    outs = fp.wrap(model)(**inputs)
    loss = BertPretrainingCriterion()(*outs, **targets)
    loss.backward()
    assert fp.summary()["rewrites"] == {
        "residual_ln": 5, "attention_block": 2, "matmul_bias_gelu": 3,
        "ln_matmul": 1}
    _assert_like_jax(model, outs, loss, jouts, jloss, jgrads)


@pytest.mark.parametrize("family", ["gpt", "bert"])
def test_pass_on_matches_pass_off_with_dropout(family):
    runs = {}
    for fusion in (True, False):
        model = _gpt() if family == "gpt" else _bert()
        run = fp.wrap(model) if fusion else model
        gen = make_generator(7, "cpu")
        if family == "gpt":
            ids = _ids()
            loss = GPTPretrainingCriterion()(run(ids, generator=gen), ids)
        else:
            inputs, targets = train.make_bert_batch(model.config, B, S,
                                                    device="cpu")
            loss = BertPretrainingCriterion()(
                *run(**inputs, generator=gen), **targets)
        loss.backward()
        runs[fusion] = (loss.item(), {n: p.grad for n, p in
                                      model.named_parameters()})
    (on, g_on), (off, g_off) = runs[True], runs[False]
    assert abs(on - off) <= 1e-6 * abs(off)
    for name in g_off:
        torch.testing.assert_close(g_on[name], g_off[name], rtol=1e-5,
                                   atol=1e-5, msg=name)


def test_train_cli_takes_the_recompute_and_fusion_flags(capsys):
    argv = ["--model", "gpt_tiny", "--batch", "2", "--seq", "32", "--steps",
            "1", "--device", "cpu"]
    assert train.main(argv + ["--no-recompute"]) == 0
    assert "no recompute, fusion pass on" in capsys.readouterr().out
    assert train.main(argv + ["--no-fusion"]) == 0
    assert "recompute, fusion pass off" in capsys.readouterr().out


# -- flash attention at cross lengths and padded head sizes ------------------------

def test_flash_cross_lengths_and_padded_head_match_jax_kernel():
    rng = np.random.RandomState(9)
    q = rng.randn(1, 2, 40, 48).astype(np.float32)
    k = rng.randn(1, 2, 72, 48).astype(np.float32)
    v = rng.randn(1, 2, 72, 48).astype(np.float32)
    g = rng.randn(1, 2, 40, 48).astype(np.float32)
    jout, vjp = jax.vjp(lambda a, b, c: jpo.mha(a, b, c, causal=True,
                                                interpret=True),
                        *(jnp.asarray(t) for t in (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = tpo.mha(tq, tk, tv, causal=True)
    out.backward(torch.from_numpy(g))
    _close(out, jout, "float32")
    for t, want in zip((tq, tk, tv), jgrads):
        _close(t.grad, want, "float32")


def test_flash_check_takes_cross_lengths_and_pads_head_sizes():
    q, do = _cuda_like((1, 40, 2, 64)), _cuda_like((1, 40, 2, 64))
    kv = _cuda_like((1, 72, 2, 64))
    shape, strides = tpo._check(q, kv, kv, do)
    assert shape == (1, 40, 72, 2, 64) and len(strides) == 12
    with pytest.raises(ValueError, match="kv_len"):
        tpo._check(q, kv, _cuda_like((1, 40, 2, 64)))
    with pytest.raises(ValueError, match="head dim 48"):
        tpo._check(*(_cuda_like(t.shape[:3] + (48,)) for t in (q, kv, kv)))
    # the wrappers pad 48 to 64, 96 to 128 and 160 to 256, and above 256
    # to the next multiple of 128
    for d, want in ((48, 64), (96, 128), (64, 64), (160, 256)):
        padded = tpo._padded(torch.ones(1, 3, 2, d), torch.ones(1, 5, 2, d))
        assert [t.shape[-1] for t in padded] == [want, want]
        assert float(padded[0][..., d:].abs().sum()) == 0.0
    assert tpo._padded(torch.ones(1, 3, 2, 257))[0].shape[-1] == 384
