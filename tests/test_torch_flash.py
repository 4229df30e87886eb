"""Parity of the PyTorch port's flash attention with the JAX package, on
the CPU, in f32 at small sizes.

The same numpy inputs (from a seed) and the same int32 dropout seed go
through the JAX function and its ``paddle_tpu_torch`` counterpart.  On
the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernels are held against those on the card by ``chip_smoke.py``.  The
JAX side runs its Pallas kernels in interpret mode.

Tolerances:
 - the dropout keep mask: identical bits;
 - out and lse against the interpret-mode ``mha``: 2e-5, the JAX
   package's own tolerance between its kernel and its reference;
 - dq, dk and dv against ``jax.grad`` of the interpret-mode ``mha``:
   3e-4, the JAX test's own;
 - a GPT at S = 512 (hidden 64, 2 layers, 4 heads) from the JAX model's
   weights, dropout 0: logits, loss and every gradient within 1e-5 (the
   JAX side takes its XLA attention on the CPU, the port its flash
   route's plain versions: the same function, summed in another order);
 - recompute on and off, attention dropout 0.1: identical bits.

Seeds cross into JAX as f32 bit patterns, so the ones used here are not
NaN patterns (small negative int32s would be).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.incubate.models import gpt as jgpt
from paddle_tpu.jit.api import functional_call
from paddle_tpu.ops import pallas_ops as jpo
from paddle_tpu.tensor import Tensor
from paddle_tpu_torch import train
from paddle_tpu_torch.framework.random import make_generator
from paddle_tpu_torch.incubate.models import (GPTConfig, GPTForCausalLM,
                                              GPTPretrainingCriterion,
                                              params_from_numpy)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import common as tcommon
from paddle_tpu_torch.ops import KERNELS
from paddle_tpu_torch.ops import pallas_ops as tpo
from paddle_tpu_torch.optimizer import AdamW

SEEDS = [12345, 0x3F800000, int(np.uint32(0xBF800000).view(np.int32))]
LONG = F.FLASH_MIN_SEQ
GPT_KW = dict(vocab_size=1024, hidden_size=64, num_layers=2,
              num_attention_heads=4, max_position_embeddings=LONG)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _jseed(seed):
    return jnp.asarray(np.int32(seed).view(np.float32))


def _qkv(seed, shape):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


# -- (a) the dropout mask ----------------------------------------------------

@pytest.mark.parametrize("p_drop", [0.1, 0.4])
@pytest.mark.parametrize("seed", SEEDS, ids=["12345", "3f800000", "bf800000"])
def test_keep_mask_equals_the_jax_tile_mask(seed, p_drop):
    rows, cols = torch.arange(256)[:, None], torch.arange(256)[None, :]
    for bh in (0, 13, 40):
        want = tpo.keep_mask(seed, bh, rows, cols, p_drop).numpy()
        for bq, bk in ((128, 128), (128, 64)):
            tiles = [[np.asarray(jpo._tile_keep_mask(
                jnp.int32(seed), bh, qi, ki, bq, bk, p_drop))
                for ki in range(256 // bk)] for qi in range(256 // bq)]
            np.testing.assert_array_equal(np.block(tiles), want)
        # the contract of the wgmma forward (128-row q tiles) and the dq
        # and dk/dv kernels (64-row tiles): a 128-row tile's mask is the
        # JAX one at block_q 128 and two 64-row ones stacked
        for qi in range(2):
            whole = np.asarray(jpo._tile_keep_mask(
                jnp.int32(seed), bh, qi, 0, 128, 256, p_drop))
            halves = np.concatenate([np.asarray(jpo._tile_keep_mask(
                jnp.int32(seed), bh, 2 * qi + j, 0, 64, 256, p_drop))
                for j in range(2)])
            np.testing.assert_array_equal(want[128 * qi:128 * (qi + 1)],
                                          whole)
            np.testing.assert_array_equal(halves, whole)
        assert abs(want.mean() - (1 - p_drop)) < 0.01


# -- (b) forward, (c) gradients against the interpret-mode kernels ------------

@pytest.mark.parametrize("dropout_p", [0.0, 0.1], ids=["nodrop", "drop0.1"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_mha_out_and_lse_match_jax_interpret(causal, dropout_p):
    q, k, v = _qkv(1, (1, 2, 256, 32))
    jo, jl = jpo.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, dropout_p=dropout_p, seed=_jseed(SEEDS[0]),
                     interpret=True, block_q=128, block_k=128,
                     return_lse=True)
    to, tl = tpo.mha(*(torch.from_numpy(a) for a in (q, k, v)),
                     causal=causal, dropout_p=dropout_p, seed=SEEDS[0],
                     return_lse=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize(
    "causal, lq, lk, d",
    [(False, 128, 128, 32), (True, 128, 128, 32), (True, 200, 264, 64)],
    # q 200 / kv 264: ragged for 64- and 128-row tiles, the causal
    # diagonal across lengths (key j kept for query i when j <= i + 64)
    ids=["full", "causal", "causal-q200-kv264-d64"])
def test_mha_grads_match_jax_grad_with_dropout(causal, lq, lk, d):
    if lq == lk:
        q, k, v = _qkv(2, (1, 2, lq, d))
    else:
        rng = np.random.RandomState(2)
        q = rng.randn(1, 2, lq, d).astype(np.float32)
        k, v = (rng.randn(1, 2, lk, d).astype(np.float32) for _ in range(2))
    w = np.random.RandomState(3).randn(1, 2, lq, d).astype(np.float32)
    seed = SEEDS[1]

    def jloss(q_, k_, v_):
        o = jpo.mha(q_, k_, v_, causal=causal, dropout_p=0.1,
                    seed=_jseed(seed), interpret=True, block_q=64,
                    block_k=64)
        return jnp.sum(o * jnp.asarray(w))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tpo.mha(*ts, causal=causal, dropout_p=0.1, seed=seed)
    (out * torch.from_numpy(w)).sum().backward()
    for t, jg, name in zip(ts, jgrads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=3e-4,
                                   rtol=3e-4, err_msg=name)


def test_bwd_reference_is_the_gradient_of_the_forward():
    # the explicit backward against autograd through the plain forward
    q, k, v = (torch.from_numpy(a).double() for a in _qkv(4, (2, 2, 64, 16)))
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    do = torch.randn(2, 2, 64, 16, generator=torch.Generator().manual_seed(0),
                     dtype=torch.float64)
    out, lse = tpo.mha_reference(*ts, causal=True, dropout_p=0.2, seed=7)
    out.backward(do)
    grads = tpo.mha_bwd_reference(q.float(), k.float(), v.float(),
                                  out.detach().float(), lse.detach().float(),
                                  do.float(), causal=True, dropout_p=0.2,
                                  seed=7)
    for t, g in zip(ts, grads):
        np.testing.assert_allclose(g.numpy(), t.grad.float().numpy(),
                                   atol=1e-5, rtol=1e-5)


# -- (d) dispatch: CPU -> plain versions, CUDA -> kernels, never both --------

def _forbid(*a, **k):
    raise AssertionError("a card tensor reached a plain version")


def _fake_launches(monkeypatch, calls):
    def fwd(q, *a, hash_base=None):
        calls.append("fwd")
        b, s, h, _ = q.shape
        return (torch.empty(q.shape, device="meta"),
                torch.empty((b, h, s), device="meta"))

    def dq(q, *a, hash_base=None):
        calls.append("dq")
        return torch.empty(q.shape, device="meta")

    def dkv(q, *a, hash_base=None):
        calls.append("dkv")
        return (torch.empty(q.shape, device="meta"),
                torch.empty(q.shape, device="meta"))

    monkeypatch.setattr(tpo, "_launch_fwd", fwd)
    monkeypatch.setattr(tpo, "_launch_dq", dq)
    monkeypatch.setattr(tpo, "_launch_dkv", dkv)


@pytest.mark.parametrize("dropout_p", [0.0, 0.1], ids=["nodrop", "drop0.1"])
def test_card_tensor_at_flash_lengths_reaches_the_three_kernels(
        monkeypatch, dropout_p):
    # a meta tensor stands in for a card tensor: it is not on the CPU
    calls = []
    _fake_launches(monkeypatch, calls)
    for name in ("mha_reference", "mha_dq_reference", "mha_dkv_reference"):
        monkeypatch.setattr(tpo, name, _forbid)
    monkeypatch.setattr(tcommon, "dropout", _forbid)
    gen = object()     # the run's generator, handed to draw_seed
    monkeypatch.setattr(tpo, "draw_seed", lambda g: (
        calls.append("seed") if g is gen else _forbid()) or torch.zeros(
            (), dtype=torch.int32, device="meta"))
    before = {n: KERNELS[n].launches for n in
              ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    x = torch.zeros(2, LONG, 2, 32, device="meta", requires_grad=True)
    out = F.scaled_dot_product_attention(x, x, x, dropout_p=dropout_p,
                                         is_causal=True, generator=gen)
    seeded = ["seed"] if dropout_p else []
    assert out.shape == x.shape and calls == seeded + ["fwd"]
    out.sum().backward()
    assert calls == seeded + ["fwd", "dq", "dkv"]
    assert {n: KERNELS[n].launches - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


class _FakeCuda(types.SimpleNamespace):
    """Stands in for a CUDA tensor: only ``device`` and ``shape`` are
    read before the dispatch decision."""


def test_cuda_tensor_reaches_each_flash_kernel_never_its_plain_version(
        monkeypatch):
    calls = []
    _fake_launches(monkeypatch, calls)
    for name in ("mha_reference", "mha_dq_reference", "mha_dkv_reference"):
        monkeypatch.setattr(tpo, name, _forbid)
    before = [KERNELS[n].launches for n in
              ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")]
    q = _FakeCuda(device=torch.device("cuda", 0), shape=(1, LONG, 2, 32))
    tpo.flash_fwd(q, q, q, causal=True)
    tpo.flash_bwd_dq(q, q, q, q, None, None, causal=True)
    tpo.flash_bwd_dkv(q, q, q, q, None, None, causal=True)
    assert calls == ["fwd", "dq", "dkv"]
    assert [KERNELS[n].launches for n in ("flash_fwd", "flash_bwd_dq",
                                          "flash_bwd_dkv")] == [
        n + 1 for n in before]


def test_below_flash_lengths_runs_plain_attention(monkeypatch):
    monkeypatch.setattr(tpo, "flash_attention", _forbid)
    short = torch.zeros(1, LONG - 1, 2, 8, device="meta")
    out = F.scaled_dot_product_attention(short, short, short, is_causal=True)
    assert out.shape == short.shape
    x = torch.randn(1, LONG - 1, 2, 8)
    assert F.scaled_dot_product_attention(x, x, x).shape == x.shape


def test_cpu_at_flash_lengths_runs_the_plain_versions(monkeypatch):
    calls = []

    def counting(name):
        fn = getattr(tpo, name)

        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    for name in ("mha_reference", "mha_dq_reference", "mha_dkv_reference"):
        monkeypatch.setattr(tpo, name, counting(name))
    for name in ("_launch_fwd", "_launch_dq", "_launch_dkv"):
        monkeypatch.setattr(tpo, name, _forbid)
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(1, LONG, 2, 8).astype(np.float32))
               .requires_grad_() for _ in range(3))
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    out.sum().backward()
    assert calls == ["mha_reference", "mha_dq_reference",
                     "mha_dkv_reference"]
    # the flash route computes the plain attention's function
    with torch.no_grad():
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(8)
        s = s.masked_fill(~torch.ones(LONG, LONG, dtype=torch.bool).tril(),
                          float("-inf"))
        want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    torch.testing.assert_close(out.detach(), want, atol=1e-5, rtol=1e-5)


def test_kernel_wrappers_take_only_cpu_or_cuda():
    x = torch.zeros(1, 64, 2, 32, device="meta")
    stats = torch.zeros(1, 2, 64, device="meta")
    with pytest.raises(ValueError, match="not a CUDA device"):
        tpo.flash_fwd(x, x, x, causal=True)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tpo.flash_bwd_dq(x, x, x, x, stats, stats)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tpo.flash_bwd_dkv(x, x, x, x, stats, stats)


def test_attention_dropout_needs_the_generator():
    x = torch.zeros(1, LONG, 2, 8)
    with pytest.raises(ValueError, match="generator"):
        F.scaled_dot_product_attention(x, x, x, dropout_p=0.1)
    # not training: no dropout, no seed
    out = F.scaled_dot_product_attention(x, x, x, dropout_p=0.1,
                                         training=False)
    assert out.shape == x.shape


def test_flash_attention_functional_matches_sdpa_and_returns_softmax():
    rng = np.random.RandomState(6)
    q, k, v = (torch.from_numpy(rng.randn(2, LONG, 2, 16).astype(np.float32))
               for _ in range(3))
    out, probs = F.flash_attention(q, k, v, causal=True)
    assert probs is None
    torch.testing.assert_close(
        out, F.scaled_dot_product_attention(q, k, v, is_causal=True),
        atol=0, rtol=0)
    out2, probs = F.flash_attention(q, k, v, causal=True,
                                    return_softmax=True)
    assert probs.shape == (2, 2, LONG, LONG) and probs.dtype == torch.float32
    torch.testing.assert_close(probs.sum(-1), torch.ones(2, 2, LONG))
    assert torch.all(probs.triu(1) == 0)
    torch.testing.assert_close(out2, out, atol=0, rtol=0)
    # dropout draws the seed from the generator: the same state, the same
    # mask
    a, _ = F.flash_attention(q, k, v, 0.1, True,
                             generator=make_generator(3, "cpu"))
    b, _ = F.flash_attention(q, k, v, 0.1, True,
                             generator=make_generator(3, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, out)


# -- (e), (f), (g): the GPT step at S = 512 ---------------------------------

def _batch(seed, b=2):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 1024, (b, LONG)).astype(np.int32),
            rng.randint(0, 1024, (b, LONG)).astype(np.int32))


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


@pytest.fixture(scope="module")
def jax_model():
    pt.seed(0)
    model = jgpt.GPTForCausalLM(jgpt.GPTConfig(tensor_parallel=False,
                                               **GPT_KW, **NO_DROPOUT))
    return model, {k: np.asarray(p._data)
                   for k, p in model.named_parameters()}


def _port(arrays, **cfg):
    kw = dict(GPT_KW, **NO_DROPOUT)
    kw.update(cfg)
    model = GPTForCausalLM(GPTConfig(**kw),
                           generator=make_generator(0, "cpu"))
    return params_from_numpy(model, arrays)


def test_gpt_at_flash_length_matches_jax(jax_model, monkeypatch):
    jm, arrays = jax_model
    ids, labels = _batch(0)
    crit = jgpt.GPTPretrainingCriterion()

    def loss_of(p):
        out, _ = functional_call(jm, p, {}, (Tensor(ids),), training=True,
                                 forward_fn=jm.forward)
        return crit(out, Tensor(labels))._data, out._data

    params = {k: p._data for k, p in jm.named_parameters()}
    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(params)

    calls = []
    real = tpo.mha_reference
    monkeypatch.setattr(tpo, "mha_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model = _port(arrays)
    logits = model(_t(ids))
    loss = GPTPretrainingCriterion()(logits, _t(labels))
    loss.backward()
    assert len(calls) == GPT_KW["num_layers"]     # the flash route ran
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=1e-5)
    assert abs(loss.item() - float(jloss)) <= 1e-5
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[name]),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def test_recompute_replays_the_attention_dropout_seed(jax_model):
    _, arrays = jax_model
    ids, labels = (_t(a) for a in _batch(1, b=1))
    runs = []
    for recompute in (False, True):
        gen = make_generator(5, "cpu")
        model = _port(arrays, attention_probs_dropout_prob=0.1,
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
    plain = GPTPretrainingCriterion()(_port(arrays)(ids), labels)
    assert not torch.equal(plain.detach(), l0)


def test_flash_calls_per_step_with_recompute(jax_model, monkeypatch):
    _, arrays = jax_model
    calls = {"fwd": 0, "dq": 0, "dkv": 0}

    def counting(kind, fn):
        def wrapped(*a, **k):
            calls[kind] += 1
            return fn(*a, **k)
        return wrapped

    for kind, name in (("fwd", "mha_reference"), ("dq", "mha_dq_reference"),
                       ("dkv", "mha_dkv_reference")):
        monkeypatch.setattr(tpo, name, counting(kind, getattr(tpo, name)))
    ids, labels = _batch(2, b=1)
    model = _port(arrays, attention_probs_dropout_prob=0.1,
                  use_recompute=True)
    step = train.TrainStep(model, GPTPretrainingCriterion(),
                           AdamW(learning_rate=1e-4), make_generator(0, "cpu"))
    loss = step(_t(ids), _t(labels))
    layers = model.config.num_layers
    # each block's forward, again in the backward pass's recompute; one
    # backward pair per block
    assert calls == {"fwd": 2 * layers, "dq": layers, "dkv": layers}
    assert torch.isfinite(loss)


# -- (h) the lse gradient, seq_lens, causal_shift, head sizes above 128 -----

def _jax_mha_vjp(q, k, v, w, wl, **kw):
    """Out, lse and the gradients of ``sum(out * w) + sum(lse * wl)``
    through the interpret-mode JAX ``mha(return_lse=True)``."""
    def loss(q_, k_, v_):
        o, lse = jpo.mha(q_, k_, v_, interpret=True, block_q=32, block_k=32,
                         return_lse=True, **kw)
        return jnp.sum(o * w) + jnp.sum(lse * wl), (o, lse)

    (_, (o, lse)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(o), np.asarray(lse), [np.asarray(g) for g in grads]


def _port_mha_grads(q, k, v, w, wl, **kw):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o, lse = tpo.mha(*ts, return_lse=True, **kw)
    ((o * torch.from_numpy(w)).sum()
     + (lse * torch.from_numpy(wl)).sum()).backward()
    return o.detach().numpy(), lse.detach().numpy(), [t.grad.numpy()
                                                      for t in ts]


def _assert_mha_matches(q, k, v, jkw, tkw, seed=8):
    rng = np.random.RandomState(seed)
    w = rng.randn(*q.shape).astype(np.float32)
    wl = rng.randn(*q.shape[:3]).astype(np.float32)
    jo, jl, jg = _jax_mha_vjp(q, k, v, w, wl, **jkw)
    to, tl, tg = _port_mha_grads(q, k, v, w, wl, **tkw)
    np.testing.assert_allclose(to, jo, atol=2e-5, rtol=2e-5, err_msg="out")
    np.testing.assert_allclose(tl, jl, atol=2e-5, rtol=2e-5, err_msg="lse")
    for g, want, name in zip(tg, jg, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, want, atol=3e-4, rtol=3e-4,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_mha_lse_gradient_matches_jax_grad(causal):
    # the loss out.sum() + lse.sum(): the lse's cotangent folds into delta
    q, k, v = _qkv(9, (1, 2, 16, 32))
    ones = np.ones((1, 2, 16, 32), np.float32)
    _assert_mha_matches(q, k, v, dict(causal=causal), dict(causal=causal))
    jo, jl, jg = _jax_mha_vjp(q, k, v, ones, ones[..., 0], causal=causal)
    to, tl, tg = _port_mha_grads(q, k, v, ones, ones[..., 0], causal=causal)
    for g, want in zip(tg, jg):
        np.testing.assert_allclose(g, want, atol=3e-4, rtol=3e-4)
    # the lse alone has a gradient too
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tpo.mha(*ts, causal=causal, return_lse=True)[1].sum().backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in ts[:2])
    assert float(ts[2].grad.abs().sum()) == 0.0   # lse does not see v


@pytest.mark.parametrize("variant", [
    dict(causal=True, seq_lens=[40, 17]),
    dict(causal=False, seq_lens=[40, 0]),
    dict(causal=True, causal_shift=5, kv=96),
    dict(causal=True, causal_shift=-20),      # the first 20 rows: no key
    dict(causal=True, causal_shift=-64),      # no row has a key
], ids=["lens-causal", "lens-full-empty", "shift-cross", "shift-empties-rows",
        "shift-empties-all"])
def test_mha_seq_lens_and_causal_shift_match_jax(variant):
    kw = dict(variant)
    kv = kw.pop("kv", 64)
    b = 2 if "seq_lens" in kw else 1
    q = np.random.RandomState(10).randn(b, 2, 64, 32).astype(np.float32)
    k, v = _qkv(11, (b, 2, kv, 32))[:2]
    jkw, tkw = dict(kw), dict(kw)
    if "seq_lens" in kw:
        jkw["seq_lens"] = jnp.asarray(kw["seq_lens"], jnp.int32)
        tkw["seq_lens"] = torch.tensor(kw["seq_lens"], dtype=torch.int32)
    if "causal_shift" in kw:
        jkw["causal_shift"] = jnp.int32(kw["causal_shift"])
        tkw["causal_shift"] = torch.tensor(kw["causal_shift"],
                                           dtype=torch.int32)
    _assert_mha_matches(q, k, v, jkw, tkw)
    if kw.get("causal_shift", 0) < 0:
        out, lse = tpo.mha(*(torch.from_numpy(a) for a in (q, k, v)),
                           return_lse=True, **tkw)
        empty = min(-kw["causal_shift"], 64)
        assert torch.all(out[:, :, :empty] == 0)
        assert torch.all(lse[:, :, :empty] == -1e30)


def test_mha_variants_refuse_what_jax_refuses():
    q, k, v = (torch.zeros(1, 2, 16, 32) for _ in range(3))
    kv = torch.zeros(1, 2, 24, 32)
    with pytest.raises(ValueError, match="seq_lens requires self-attention"):
        tpo.mha(q, kv, kv, seq_lens=[4])
    with pytest.raises(ValueError, match="causal_shift requires causal"):
        tpo.mha(q, k, v, causal_shift=3)


@pytest.mark.parametrize("d", [160, 256, 320])
def test_mha_head_sizes_above_128_match_jax(d):
    q = np.random.RandomState(12).randn(1, 2, 40, d).astype(np.float32)
    k, v = _qkv(13, (1, 2, 72, d))[:2]
    kw = dict(causal=True, dropout_p=0.1)
    _assert_mha_matches(q, k, v, dict(kw, seed=_jseed(SEEDS[0])),
                        dict(kw, seed=SEEDS[0]))


def test_padded_pads_129_to_256_and_refuses_257():
    for d in (129, 200, 256):
        padded = tpo._padded(torch.ones(1, 3, 2, d), torch.ones(1, 5, 2, d))
        assert [t.shape[-1] for t in padded] == [256, 256]
        assert float(padded[1][..., d:].abs().sum()) == 0.0
    # above 256 the kernels take every multiple of 128: 257 pads to 384
    assert tpo._padded(torch.ones(1, 3, 2, 257))[0].shape[-1] == 384


def test_cuda_tensor_carries_seq_lens_and_causal_shift_to_the_kernels(
        monkeypatch):
    seen = []

    def launch(q, *a, hash_base=None):
        assert hash_base is None
        seen.append(a[-2:])
        return (torch.empty(q.shape, device="meta"),
                torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                            device="meta"))

    for name in ("_launch_fwd", "_launch_dq", "_launch_dkv"):
        monkeypatch.setattr(tpo, name, launch)
    for name in ("mha_reference", "mha_dq_reference", "mha_dkv_reference"):
        monkeypatch.setattr(tpo, name, _forbid)
    q = _FakeCuda(device=torch.device("cuda", 0), shape=(2, 64, 2, 32))
    lens, shift = object(), object()
    tpo.flash_fwd(q, q, q, causal=True, seq_lens=lens, causal_shift=shift)
    tpo.flash_bwd_dq(q, q, q, q, None, None, causal=True, seq_lens=lens,
                     causal_shift=shift)
    tpo.flash_bwd_dkv(q, q, q, q, None, None, causal=True, seq_lens=lens,
                      causal_shift=shift)
    assert seen == [(lens, shift)] * 3
