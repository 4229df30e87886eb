"""Parity of the PyTorch port's serving path with the JAX package, on
the CPU, at a small width.

The JAX package's weights (from its own ``init_params``) go to the port
as numpy arrays through ``params_from_numpy``; both packages then run
the same prompts.  Tolerances: prefill and decode logits agree to
atol 1e-4 in f32 (matrix products summed in another order) with equal
next tokens; ``generate`` gives identical tokens at fp32 and int8.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.serving import (ModelSpec as JSpec, ServeConfig as JConfig,
                                ServingEngine as JEngine,
                                init_params as jax_init_params)
from paddle_tpu.serving import model as jmodel
from paddle_tpu.serving.quant import quantize_params as jax_quantize_params
from paddle_tpu_torch.serving import (ModelSpec, ServeConfig, ServingEngine,
                                      params_from_numpy)
from paddle_tpu_torch.serving import model as tmodel
from paddle_tpu_torch.serving.quant import (is_quantized_params,
                                            quantize_params)

SPEC = ModelSpec(vocab_size=64, hidden=32, layers=2, heads=2, max_seq_len=64)
JSPEC = JSpec(**SPEC.to_dict())
PS = 4
CFG = dict(decode_buckets=(4,), prefill_buckets=(16,), kv_pages=32,
           page_size=PS, max_inflight=16, max_new_tokens=8)


@pytest.fixture(scope="module")
def np_params():
    return {k: np.asarray(v) for k, v in jax_init_params(JSPEC, 0).items()}


def _prompts(seed, n):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, SPEC.vocab_size, size=rng.randint(2, 12)).tolist()
            for _ in range(n)]


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_prefill_and_decode_steps_match_jax(np_params, precision):
    import jax.numpy as jnp
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    if precision == "int8":
        jparams = jax_quantize_params(jparams, JSPEC)
    tparams = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                                "cpu")
    quant = precision == "int8"
    pages, maxp = 1 + 3 * 16, 16
    shape = (SPEC.layers, pages * PS, SPEC.heads, SPEC.head_dim)
    kv_np = np.int8 if quant else np.float32
    jstate = [jnp.zeros(shape, kv_np), jnp.zeros(shape, kv_np)]
    tstate = [torch.zeros(shape, dtype=torch.int8 if quant else torch.float32)
              for _ in range(2)]
    if quant:
        jstate += [jnp.zeros(shape[:3], jnp.float32)] * 2
        tstate += [torch.zeros(shape[:3]) for _ in range(2)]
    rng = np.random.RandomState(3)
    tables = rng.permutation(np.arange(1, pages))[:3 * maxp] \
        .reshape(3, maxp).astype(np.int32)
    lengths = [3, 9, 14]

    def scales(state):
        return {"k_scale": state[2], "v_scale": state[3]} if quant else {}

    for row, n in enumerate(lengths):
        toks = np.zeros((16,), np.int32)
        toks[:n] = rng.randint(1, SPEC.vocab_size, size=n)
        *jstate_new, jtok, jlog = jmodel.prefill_step(
            JSPEC, jparams, jstate[0], jstate[1], toks, np.int32(n),
            tables[row], page_size=PS, **scales(jstate))
        jstate = jstate_new
        *tout, ttok, tlog = tmodel.prefill_step(
            SPEC, tparams, tstate[0], tstate[1], torch.from_numpy(toks), n,
            torch.from_numpy(tables[row]), page_size=PS, **scales(tstate))
        assert all(a is b for a, b in zip(tout, tstate))  # in place
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
        assert int(ttok) == int(jtok)

    # the pools hold the same K/V after prefill
    np.testing.assert_allclose(tstate[0].float().numpy(),
                               np.asarray(jstate[0], np.float32), atol=1e-4)

    # a decode bucket of 4: three live rows and one padding row
    tok = np.array([5, 17, 42, 0], np.int32)
    pos = np.array(lengths + [0], np.int32)
    pt = np.zeros((4, maxp), np.int32)
    pt[:3] = tables
    *_, jnext, jlog = jmodel.decode_step(
        JSPEC, jparams, jstate[0], jstate[1], tok, pos, pt, page_size=PS,
        **scales(jstate))
    *_, tnext, tlog = tmodel.decode_step(
        SPEC, tparams, tstate[0], tstate[1], torch.from_numpy(tok),
        torch.from_numpy(pos), torch.from_numpy(pt), page_size=PS,
        **scales(tstate))
    np.testing.assert_allclose(tlog[:3].numpy(), np.asarray(jlog)[:3],
                               atol=1e-4)
    assert tnext[:3].tolist() == np.asarray(jnext)[:3].tolist()


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_generate_matches_jax_engine(np_params, precision):
    prompts = _prompts(2, 7)
    jeng = JEngine(JSPEC, np_params, JConfig(**CFG, precision=precision))
    try:
        want = jeng.generate(prompts, max_new_tokens=8)
    finally:
        jeng.close()
    eng = ServingEngine(SPEC, np_params,
                        ServeConfig(**CFG, precision=precision), device="cpu")
    assert eng.generate(prompts, max_new_tokens=8) == want
    assert eng.pool.k_flat.dtype == (torch.int8 if precision == "int8"
                                     else torch.float32)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_continuous_batching_bit_identical_to_solo(np_params, precision):
    eng = ServingEngine(SPEC, np_params,
                        ServeConfig(**CFG, precision=precision), device="cpu")
    prompts = _prompts(4, 7)
    # solo: one request at a time, padded into the 4-bucket; batched: all
    # seven compete for it, so each sees neighbours join and leave
    solo = [eng.generate([p], max_new_tokens=8)[0] for p in prompts]
    assert eng.generate(prompts, max_new_tokens=8) == solo
    eng.pool.check_consistency(expect_all_free=True)
    health = eng.healthz()
    assert health["ok"] and health["unexpected_compiles"] == 0
    assert health["compiled_programs"] == 2
    assert health["precision"] == precision


def test_quantized_tree_carries_over_and_matches(np_params):
    import jax.numpy as jnp
    jq = jax_quantize_params({k: jnp.asarray(v) for k, v in
                              np_params.items()}, JSPEC)
    carried = params_from_numpy({k: np.asarray(v) for k, v in jq.items()},
                                "cpu")
    mine = quantize_params(params_from_numpy(np_params, "cpu"), SPEC)
    assert is_quantized_params(carried) and is_quantized_params(mine)
    assert list(carried) == list(mine)
    for name in mine:
        assert torch.equal(carried[name], mine[name]), name
    # an engine given the quantized tree serves the same tokens as one
    # that quantizes inline
    cfg = ServeConfig(**CFG, precision="int8")
    prompts = _prompts(5, 3)
    a = ServingEngine(SPEC, carried, cfg, device="cpu").generate(prompts)
    b = ServingEngine(SPEC, np_params, cfg, device="cpu").generate(prompts)
    assert a == b


def test_params_from_numpy_checks_names_shapes_and_dtype(np_params):
    bf = params_from_numpy(np_params, "cpu", dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in bf.values())
    bad = dict(np_params)
    bad["h0.attn.wq"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="wrong shape"):
        params_from_numpy(bad, "cpu")
    missing = dict(np_params)
    del missing["h1.mlp.b2"]
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(missing, "cpu")
    extra = dict(np_params, stray=np.zeros((2,), np.float32))
    with pytest.raises(ValueError, match="unexpected"):
        params_from_numpy(extra, "cpu")
    q = quantize_params(params_from_numpy(np_params, "cpu"), SPEC)
    q["h0.mlp.w1::q"] = q["h0.mlp.w1::q"].float()
    with pytest.raises(ValueError, match="int8"):
        params_from_numpy(q, "cpu")


def test_install_weights_swaps_and_validates(np_params):
    eng = ServingEngine(SPEC, np_params, ServeConfig(**CFG), device="cpu")
    prompt = [3, 1, 4, 1, 5]
    base = eng.generate([prompt], max_new_tokens=6)[0]
    # all-zero weights make every logit equal: greedy argmax takes the
    # first index, so the swap shows as token 0 throughout
    eng.install_weights({k: np.zeros_like(v) for k, v in np_params.items()},
                        step=9)
    assert eng.weights_step == 9
    assert eng.generate([prompt], max_new_tokens=6)[0] == [0] * 6
    bad = dict(np_params)
    bad["embed"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        eng.install_weights(bad)
    eng.install_weights(np_params, step=1)
    assert eng.generate([prompt], max_new_tokens=6)[0] == base


def test_init_params_is_seeded_and_shaped():
    a = tmodel.init_params(SPEC, seed=3, device="cpu")
    b = tmodel.init_params(SPEC, seed=3, device="cpu")
    c = tmodel.init_params(SPEC, seed=4, device="cpu")
    assert list(a) == list(jax_init_params(JSPEC, 0))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    assert torch.equal(a["h0.ln1.w"], torch.ones(SPEC.hidden))
    params_from_numpy(a, "cpu")  # names and shapes are the serve layout
