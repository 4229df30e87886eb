"""The captured step (``paddle_tpu_torch.jit.capture``) and what the
modules it captures needed for it, on the CPU at a small width.

 - AdamW with its step count a 0-d int32 tensor: 5 updates of gpt_tiny's
   weights (carried by ``params_from_numpy``) within 1e-6 of the JAX
   package's ``apply_gradients_tree``, slots and masters too, and the
   step equal to the JAX tree's ``step``.
 - ``prefill_step`` with the prompt length as a 0-d int32 tensor: the JAX
   step's first token, logits and KV pages within 2e-5.
 - ``install_weights`` copies into the served tensors (their storage
   kept, as the card's graphs need) and the next tokens become the new
   weights'.
 - ``CapturedStep`` on CPU tensors runs the step as written and reports
   ``fallback == "cpu"``; ``PT_CAPTURE=0`` turns capture off; the cache
   key changes with shape, dtype and ``training`` and with nothing else.
 - recompute's rerun draws the forward's numbers and gives the generator
   back where it stood, so a captured step advances it as an eager one.
 - ``import paddle_tpu_torch.jit`` loads no JAX.
The graphs themselves need the card: ``chip_smoke.py`` phase 11.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.incubate.models import gpt as jgpt
from paddle_tpu.serving import (ModelSpec as JSpec,
                                init_params as jax_init_params)
from paddle_tpu.serving import model as jmodel
from paddle_tpu.serving.quant import quantize_params as jax_quantize_params
from paddle_tpu_torch import train
from paddle_tpu_torch.distributed.fleet import recompute
from paddle_tpu_torch.framework.random import make_generator
from paddle_tpu_torch.incubate.models import (GPTForCausalLM, gpt_tiny,
                                              params_from_numpy)
from paddle_tpu_torch.jit import CapturedStep, capture_step
from paddle_tpu_torch.jit import capture as tcap
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import pallas_ops
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import ModelSpec, ServeConfig, ServingEngine
from paddle_tpu_torch.serving import model as tmodel
from paddle_tpu_torch.serving import params_from_numpy as serve_params

REPO = Path(__file__).resolve().parents[1]
LR, STEPS = 1e-3, 5
SPEC = ModelSpec(vocab_size=64, hidden=32, layers=2, heads=2, max_seq_len=64)
JSPEC = JSpec(**SPEC.to_dict())
PS = 4
CFG = dict(decode_buckets=(4,), prefill_buckets=(16,), kv_pages=32,
           page_size=PS, max_inflight=16, max_new_tokens=8)


# -- the optimizer's step on the device --------------------------------------

@pytest.fixture(scope="module")
def gpt_arrays():
    pt.seed(0)
    model = jgpt.GPTForCausalLM(jgpt.gpt_tiny(tensor_parallel=False))
    return {k: np.asarray(p._data) for k, p in model.named_parameters()}


@pytest.mark.parametrize("low", [False, True], ids=["f32", "bf16_masters"])
def test_adamw_tensor_step_matches_jax_tree(gpt_arrays, low):
    import jax.numpy as jnp
    model = GPTForCausalLM(gpt_tiny(), generator=make_generator(0, "cpu"))
    params_from_numpy(model, gpt_arrays)
    dt = torch.bfloat16 if low else torch.float32
    tp = {n: p.detach().to(dt) for n, p in model.named_parameters()}
    jdt = jnp.bfloat16 if low else jnp.float32
    jp = {n: jnp.asarray(a, jdt) for n, a in gpt_arrays.items()}
    rng = np.random.RandomState(4)
    grads = [{n: rng.randn(*a.shape).astype(np.float32)
              for n, a in gpt_arrays.items()} for _ in range(STEPS)]
    jopt = pt.optimizer.AdamW(learning_rate=LR,
                              parameters=pt.nn.Linear(2, 2).parameters(),
                              multi_precision=True)
    topt = AdamW(learning_rate=LR, multi_precision=True)
    jstate, tstate = jopt.init_state_tree(jp), topt.init_state_tree(tp)
    step = tstate["step"]
    assert step.dtype == torch.int32 and step.dim() == 0 and int(step) == 0
    for g in grads:
        jp, jstate = jopt.apply_gradients_tree(
            jp, {n: jnp.asarray(a, jdt) for n, a in g.items()}, jstate)
        topt.apply_gradients_tree(
            tp, {n: torch.from_numpy(a).to(dt) for n, a in g.items()},
            tstate)
    # counted in place, the reference's int32 layout
    assert tstate["step"] is step and step.dtype == torch.int32
    assert int(step) == int(jstate["step"]) == STEPS
    assert np.asarray(jstate["step"]).dtype == np.int32
    assert set(tstate["master"]) == (set(gpt_arrays) if low else set())
    for n in gpt_arrays:
        got = tstate["master"][n] if low else tp[n]
        want = jstate["master"][n] if low else jp[n]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6, err_msg=n)
        for slot in ("moment1", "moment2"):
            np.testing.assert_allclose(
                tstate["slots"][slot][n].numpy(),
                np.asarray(jstate["slots"][slot][n], np.float32), rtol=0,
                atol=1e-6, err_msg=f"{slot} {n}")


# -- serving: the length on the device, the weights in place -----------------

@pytest.fixture(scope="module")
def np_params():
    return {k: np.asarray(v) for k, v in jax_init_params(JSPEC, 0).items()}


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_prefill_step_tensor_length_matches_jax(np_params, precision):
    import jax.numpy as jnp
    quant = precision == "int8"
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    if quant:
        jparams = jax_quantize_params(jparams, JSPEC)
    tparams = serve_params({k: np.asarray(v) for k, v in jparams.items()},
                           "cpu")
    pages, maxp = 1 + 3 * 4, 4
    shape = (SPEC.layers, pages * PS, SPEC.heads, SPEC.head_dim)
    jstate = [jnp.zeros(shape, np.int8 if quant else np.float32)] * 2
    tstate = [torch.zeros(shape, dtype=torch.int8 if quant else torch.float32)
              for _ in range(2)]
    if quant:
        jstate += [jnp.zeros(shape[:3], jnp.float32)] * 2
        tstate += [torch.zeros(shape[:3]) for _ in range(2)]
    rng = np.random.RandomState(8)
    tables = rng.permutation(np.arange(1, pages))[:3 * maxp] \
        .reshape(3, maxp).astype(np.int32)

    def scales(state):
        return {"k_scale": state[2], "v_scale": state[3]} if quant else {}

    for row, n in enumerate([1, 9, 16]):
        toks = np.zeros((16,), np.int32)
        toks[:n] = rng.randint(1, SPEC.vocab_size, size=n)
        *jstate, jtok, jlog = jmodel.prefill_step(
            JSPEC, jparams, *jstate[:2], toks, np.int32(n), tables[row],
            page_size=PS, **scales(jstate))
        *_, ttok, tlog = tmodel.prefill_step(
            SPEC, tparams, *tstate[:2], torch.from_numpy(toks),
            torch.tensor(n, dtype=torch.int32), torch.from_numpy(tables[row]),
            page_size=PS, **scales(tstate))
        assert int(ttok) == int(jtok)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=2e-5,
                                   rtol=2e-5)
    for got, want in zip(tstate, jstate):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=2e-5,
                                   rtol=2e-5)


def _prompts(seed, n):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, SPEC.vocab_size, size=rng.randint(2, 12)).tolist()
            for _ in range(n)]


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_install_weights_copies_in_place(np_params, precision):
    cfg = ServeConfig(**CFG, precision=precision)
    new = {k: np.asarray(v) for k, v in jax_init_params(JSPEC, 1).items()}
    prompts = _prompts(2, 5)
    given = serve_params(np_params, "cpu")
    kept = {n: t.clone() for n, t in given.items()}
    eng = ServingEngine(SPEC, given, cfg, device="cpu")
    ptrs = {n: t.data_ptr() for n, t in eng._params.items()}
    before = eng.generate(prompts, max_new_tokens=6)
    eng.install_weights(new, step=3)
    assert {n: t.data_ptr() for n, t in eng._params.items()} == ptrs
    assert eng.weights_step == 3
    after = eng.generate(prompts, max_new_tokens=6)
    want = ServingEngine(SPEC, new, cfg, device="cpu").generate(
        prompts, max_new_tokens=6)
    assert after == want and after != before
    # the caller's tensors were not written: the engine owns its weights
    assert all(torch.equal(given[n], kept[n]) for n in kept)


# -- the captured step on the CPU --------------------------------------------

def test_captured_step_on_cpu_runs_the_step():
    lin = torch.nn.Linear(4, 3)

    def fn(x, scale=2.0):
        return {"y": lin(x) * scale, "n": x.shape[0]}

    step = capture_step(fn)
    assert isinstance(step, CapturedStep)
    x = torch.randn(5, 4)
    out = step(x, scale=3.0)
    torch.testing.assert_close(out["y"], lin(x) * 3.0, rtol=0, atol=0)
    assert out["n"] == 5
    assert step.stats["fallback"] == step.fallback_reason == "cpu"
    assert {k: step.stats[k] for k in ("hits", "misses", "compiles")} == {
        "hits": 0, "misses": 0, "compiles": 0}
    assert set(step.stats) == {"hits", "misses", "compiles", "fallback",
                               "fusion_rewrites", "fusion_patterns"}
    step.reset()
    assert step.stats["fallback"] is None and step.fallback_reason is None


def test_train_step_runs_captured_and_eager_alike_on_cpu():
    cfg = gpt_tiny(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    ids, labels = train.make_batch(cfg, 2, 32, device="cpu")
    steps = [train.build_train_step(cfg, device="cpu", amp_o2=False,
                                    fusion=False) for _ in range(2)]
    a = [steps[0](ids, labels) for _ in range(2)]
    b = [steps[1].eager(ids, labels) for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert steps[0].captured.stats["fallback"] == "cpu"
    assert int(steps[0].state["step"]) == 2


def test_pt_capture_0_turns_capture_off(monkeypatch):
    monkeypatch.setenv("PT_CAPTURE", "0")
    step = capture_step(lambda x: x + 1)
    assert torch.equal(step(torch.zeros(2)), torch.ones(2))
    assert step.stats["fallback"] is None and step.stats["misses"] == 0


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(3, 3)
        self.drop = torch.nn.Dropout(0.1)

    def forward(self, x):
        return self.drop(self.lin(x))


def _key(fn, *args, **kwargs):
    leaves = []
    struct = tcap._flatten((args, kwargs), leaves)
    modules = [o for o in tcap._reachable(fn)
               if isinstance(o, torch.nn.Module)]
    return tcap._signature(struct, leaves, modules)


@pytest.mark.parametrize("change, differs", [
    ("shape", True), ("dtype", True), ("training", True),
    ("submodule_training", True), ("values", False), ("new_tensor", False),
    ("weights", False), ("same_scalar", False)])
def test_cache_key_changes_with_shape_dtype_and_training_only(change,
                                                              differs):
    net = _Net()

    def fn(x, k=2):
        return net(x) * k

    x = torch.randn(4, 3)
    base = _key(fn, x, k=2)
    if change == "shape":
        key = _key(fn, torch.randn(5, 3), k=2)
    elif change == "dtype":
        key = _key(fn, x.double(), k=2)
    elif change == "training":
        net.eval()
        key = _key(fn, x, k=2)
    elif change == "submodule_training":
        net.drop.eval()
        key = _key(fn, x, k=2)
    elif change == "values":
        key = _key(fn, x + 1, k=2)
    elif change == "new_tensor":
        key = _key(fn, x.clone(), k=2)
    elif change == "weights":
        with torch.no_grad():
            net.lin.weight.add_(1)
        key = _key(fn, x, k=2)
    else:
        key = _key(fn, x, k=int("2"))
    assert (key != base) == differs
    hash(key)


def test_reachable_follows_the_discovery_rule():
    cfg = gpt_tiny()
    step = train.build_train_step(cfg, device="cpu", amp_o2=False,
                                  fusion=False)
    found = tcap._reachable(step.eager)
    assert step.model in found and step.criterion in found
    assert step.generator in found and step.optimizer in found
    assert any(o is step.state["step"] for o in found)


# -- recompute inside a capture ------------------------------------------------

def test_recompute_rerun_replays_and_restores_the_generator():
    """The rerun in the backward pass draws what the forward drew and
    gives the generator back the state it had before the rerun: the host
    state read and set here is what a capture reads and sets for the
    graph, so a captured step advances the generator as an eager one."""
    def block(x, generator=None):
        return F.dropout(x * 2.0, 0.5, training=True, generator=generator)

    x = torch.randn(64, 8)
    gen = make_generator(5, "cpu")
    start = gen.get_state()
    xa = x.clone().requires_grad_(True)
    block(xa, generator=gen).square().sum().backward()
    after = gen.get_state()

    gen.set_state(start)
    xb = x.clone().requires_grad_(True)
    y = recompute(block, xb, generator=gen)
    assert torch.equal(gen.get_state(), after)
    torch.rand(3, generator=gen)          # a draw between the two passes
    between = gen.get_state()
    y.square().sum().backward()
    assert torch.equal(xa.grad, xb.grad)
    assert torch.equal(gen.get_state(), between)


# -- the graph-safe helpers -----------------------------------------------------

def test_int_scalars_are_filled_on_the_device():
    seed = pallas_ops._seed_tensor(7, 0.1, torch.device("cpu"))
    assert seed.dtype == torch.int32 and seed.dim() == 0 and int(seed) == 7
    assert pallas_ops._seed_tensor(7, 0.0, torch.device("cpu")) is None
    t = torch.tensor(3, dtype=torch.int32)
    assert pallas_ops._seed_tensor(t, 0.1, torch.device("cpu")) is t


def test_importing_jit_loads_no_jax():
    code = ("import sys\n"
            "import paddle_tpu_torch.jit\n"
            "import paddle_tpu_torch.train\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_capture_keeps_the_collector_off_while_recording(monkeypatch):
    # a CUDA graph that the cyclic collector frees during another capture
    # resets itself, which a capture does not permit (on the card an
    # earlier engine's graphs, collected while the int8 serving engine
    # recorded, invalidated its capture): the collector stays off while a
    # graph records, and is back on after, also when the recorded
    # function raises.  Cyclic garbage is collected just before (on the
    # card an old step's graph, alive in a cycle, kept gradient
    # accumulators of another stream and failed a capture)
    import contextlib
    import gc
    import types

    class Graph:
        def capture_begin(self, pool=None):
            pass

        def capture_end(self):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    stream = types.SimpleNamespace(device="cpu")
    seen = []
    collect = gc.collect
    monkeypatch.setattr(gc, "collect",
                        lambda *a: seen.append("collect") or collect(*a))

    def fn(fail):
        seen.append(gc.isenabled())
        if fail:
            raise ValueError("recorded function failed")
        return torch.zeros(2)

    assert gc.isenabled()
    tcap.CapturedGraph.capture(fn, (False,), {}, stream=stream, pool=None)
    with pytest.raises(ValueError, match="recorded function failed"):
        tcap.CapturedGraph.capture(fn, (True,), {}, stream=stream, pool=None)
    assert seen == ["collect", False, "collect", False] and gc.isenabled()
