"""The port's learning-rate schedules, gradient clips, the learning rate
on the device, L-BFGS and a scheduled, clipped training step, against
the JAX package on the CPU.

 - every schedule of ``optimizer/lr.py`` (17, some in several modes): the
   ``get_lr()`` sequence over 30 steps exactly equal, ``LinearWarmup``
   around another schedule and ``ReduceOnPlateau`` fed the same metrics
   included; ``state_dict`` equal, and a ``set_state_dict`` round trip
   continues as the JAX package's does (``MultiplicativeDecay``'s running
   rate is not in its state in either package);
 - the clips' eager forms (``(param, grad)`` pairs, ``need_clip``,
   ``clip_grad_norm_`` at norms 2, 1 and inf, ``clip_grad_value_``)
   within 1e-6;
 - the update reads the learning rate only from its tensor: writing the
   tensor alone changes the update, ``set_lr`` under a scheduler raises;
 - gpt_tiny (f32, dropout 0) through ``TrainStep`` for 6 steps under
   ``LinearWarmup(CosineAnnealingDecay)`` and ``ClipGradByGlobalNorm``
   against the JAX step given ``lr=sched()``: losses within 1e-5, the
   learning-rate tensor ``np.float32`` of the schedule's value each step;
 - L-BFGS on the JAX tests' least-squares quadratic, with and without the
   strong-Wolfe search: the first loss and the solution's loss within
   1e-5 (relative) of the JAX package's; without the search the solution
   itself within 1e-5; with it both within the JAX test's 1e-3 of the
   least-squares solution (both end on the f32 noise floor of the loss,
   where a last-bit difference steers the search); the ``state_dict``
   round trip.
"""
import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.incubate.models import gpt as jgpt
from paddle_tpu.jit.api import functional_call
from paddle_tpu.nn import clip as jclip
from paddle_tpu.tensor import Tensor
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import train
from paddle_tpu_torch.framework.random import make_generator
from paddle_tpu_torch.incubate.models import (GPTForCausalLM,
                                              GPTPretrainingCriterion,
                                              gpt_tiny, params_from_numpy)
from paddle_tpu_torch.optimizer import LBFGS, SGD, AdamW
from paddle_tpu_torch.optimizer import lr as tlr

jlr = pt.optimizer.lr

# -- schedules -----------------------------------------------------------------

SCHEDULES = {
    "Noam": lambda m: m.NoamDecay(d_model=64, warmup_steps=5,
                                  learning_rate=2.0),
    "Piecewise": lambda m: m.PiecewiseDecay([3, 9, 20], [0.1, 0.05, 0.01,
                                                         0.001]),
    "NaturalExp": lambda m: m.NaturalExpDecay(0.1, gamma=0.1),
    "InverseTime": lambda m: m.InverseTimeDecay(0.1, gamma=0.5),
    "Polynomial": lambda m: m.PolynomialDecay(0.1, decay_steps=12,
                                              end_lr=0.0, power=1.0),
    "Polynomial_cycle": lambda m: m.PolynomialDecay(
        0.1, decay_steps=7, end_lr=0.001, power=2.0, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(0.1, warmup_steps=5,
                                             start_lr=0.0, end_lr=0.1),
    "LinearWarmup_cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.1, T_max=12), warmup_steps=4,
        start_lr=0.0, end_lr=0.1),
    "LinearWarmup_polynomial": lambda m: m.LinearWarmup(
        m.PolynomialDecay(0.1, decay_steps=12, end_lr=0.0), 4, 0.0, 0.1),
    "Exponential": lambda m: m.ExponentialDecay(0.1, gamma=0.9),
    "MultiStep": lambda m: m.MultiStepDecay(0.1, milestones=[4, 9, 15],
                                            gamma=0.3),
    "Step": lambda m: m.StepDecay(0.1, step_size=4, gamma=0.5),
    "Lambda": lambda m: m.LambdaDecay(0.1, lambda e: 0.95 ** e),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(
        0.1, factor=0.5, patience=2, cooldown=1, threshold=0.01),
    "ReduceOnPlateau_max_abs": lambda m: m.ReduceOnPlateau(
        0.1, mode="max", factor=0.3, patience=1, threshold=0.05,
        threshold_mode="abs", min_lr=0.005),
    "CosineAnnealing": lambda m: m.CosineAnnealingDecay(0.1, T_max=10,
                                                        eta_min=0.01),
    "Multiplicative": lambda m: m.MultiplicativeDecay(0.1, lambda e: 0.9),
    "OneCycle": lambda m: m.OneCycleLR(0.1, total_steps=25),
    "OneCycle_linear": lambda m: m.OneCycleLR(0.1, total_steps=25,
                                              anneal_strategy="linear"),
    "Cyclic": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4),
    "Cyclic_triangular2": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=3, step_size_down=5, mode="triangular2"),
    "Cyclic_exp_range": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4,
                                             mode="exp_range",
                                             exp_gamma=0.9),
    "LinearLR": lambda m: m.LinearLR(0.1, total_steps=10),
    "CosineWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=4, T_mult=2, eta_min=0.001),
}
# a loss that falls, stalls, rises and falls again (ReduceOnPlateau)
METRICS = [1.0, 0.8, 0.79, 0.795, 0.8, 0.81, 0.6, 0.6, 0.61, 0.62, 0.63,
           0.5, 0.5, 0.5, 0.5, 0.49, 0.7, 0.7, 0.7, 0.3, 0.3, 0.31, 0.32,
           0.33, 0.34, 0.2, 0.2, 0.2, 0.2, 0.2]


def _run(sched, n, start=0, tensor_metrics=False):
    """``n`` learning rates: each read, then the schedule stepped."""
    out = []
    for i in range(start, start + n):
        out.append(sched())
        if isinstance(sched, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
            metric = METRICS[i % len(METRICS)]
            sched.step(torch.tensor(metric, dtype=torch.float64)
                       if tensor_metrics else metric)
        else:
            sched.step()
    return out


def test_every_schedule_is_ported():
    assert set(tlr.__all__) == set(jlr.__all__)
    assert len(tlr.__all__) == 18  # the base and 17 schedules
    bases = {type(SCHEDULES[k](tlr)).__name__ for k in SCHEDULES}
    assert bases == set(tlr.__all__) - {"LRScheduler"}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax(name):
    js, ts = SCHEDULES[name](jlr), SCHEDULES[name](tlr)
    assert _run(ts, 30, tensor_metrics=True) == _run(js, 30)
    assert ts.state_dict() == js.state_dict()
    assert ts.state_keys() == js.state_keys()
    # a fresh schedule restored from the state continues as the JAX
    # package's restored schedule does
    jr, tr = SCHEDULES[name](jlr), SCHEDULES[name](tlr)
    jr.set_state_dict(copy.deepcopy(js.state_dict()))
    tr.set_dict(copy.deepcopy(ts.state_dict()))
    assert tr.state_dict() == jr.state_dict() == js.state_dict()
    restored = _run(tr, 10, start=30)
    assert restored == _run(jr, 10, start=30)
    if name != "Multiplicative":     # its running rate is not state
        assert _run(ts, 10, start=30) == restored


def test_schedule_verbose_logs(caplog):
    with caplog.at_level("INFO", logger="paddle_tpu_torch.optimizer.lr"):
        sched = tlr.StepDecay(0.1, step_size=1, verbose=True)
        sched.step()
    assert "set learning rate to 0.01" in caplog.text


# -- the learning rate on the device -------------------------------------------

def _tree(seed=3):
    rng = np.random.RandomState(seed)
    return ({"w": torch.from_numpy(rng.randn(4, 3).astype(np.float32))},
            {"w": torch.from_numpy(rng.randn(4, 3).astype(np.float32))})


def test_update_reads_only_the_learning_rate_tensor():
    out = {}
    for name, lr, written in (("a", 1e-3, None), ("b", 1e-3, 5e-3),
                              ("c", 5e-3, None)):
        params, grads = _tree()
        opt = AdamW(learning_rate=lr)
        state = opt.init_state_tree(params)
        if written is not None:
            opt.lr_tensor.fill_(written)      # the tensor alone
        opt.apply_gradients_tree(params, grads, state)
        out[name] = (params["w"], opt.get_lr())
    assert out["b"][1] == 1e-3                # the float did not move
    assert torch.equal(out["b"][0], out["c"][0])
    assert not torch.equal(out["a"][0], out["b"][0])


def test_lr_argument_float_and_tensor_and_set_lr():
    params, grads = _tree()
    ref, _ = _tree()
    opt, plain = SGD(learning_rate=0.5), SGD(learning_rate=0.1)
    state, pstate = opt.init_state_tree(params), plain.init_state_tree(ref)
    opt.apply_gradients_tree(params, grads, state, lr=0.1)
    plain.apply_gradients_tree(ref, grads, pstate)
    assert torch.equal(params["w"], ref["w"])
    opt.apply_gradients_tree(params, grads, state, lr=torch.tensor(0.1))
    plain.apply_gradients_tree(ref, grads, pstate)
    assert torch.equal(params["w"], ref["w"])
    assert opt.lr_tensor.item() == np.float32(0.5)
    opt.set_lr(0.25)                          # writes the tensor at once
    assert opt.lr_tensor.item() == 0.25 and opt.get_lr() == 0.25
    assert opt._learning_rate_scheduler is None


def test_schedule_reaches_the_tensor_through_write_lr():
    sched = tlr.StepDecay(0.1, step_size=1, gamma=0.5)
    opt = SGD(learning_rate=sched)
    opt.init_state_tree(_tree()[0])
    assert opt._learning_rate_scheduler is sched
    with pytest.raises(RuntimeError, match="scheduler"):
        opt.set_lr(0.3)
    sched.step()
    assert opt.lr_tensor.item() == np.float32(0.1)   # not yet written
    opt.write_lr()
    assert opt.lr_tensor.item() == np.float32(0.05)
    opt.set_lr_scheduler(tlr.ExponentialDecay(0.2, gamma=0.5))
    assert opt.lr_tensor.item() == np.float32(0.2)


# -- clips, eager forms -----------------------------------------------------------

def _pairs(seed, need_clip=None):
    rng = np.random.RandomState(seed)
    shapes = [(5, 4), (7,), (3, 3)]
    arrays = [rng.randn(*s).astype(np.float32) * 2 for s in shapes]
    jp, tp = [], []
    for i, a in enumerate(arrays):
        jx = pt.to_tensor(a, stop_gradient=False)
        tx = torch.nn.Parameter(torch.from_numpy(a.copy()))
        if need_clip is not None:
            # the pairs' first element: only its need_clip is read
            jx = tx = types.SimpleNamespace(need_clip=need_clip[i])
        jp.append(jx)
        tp.append(tx)
    return arrays, jp, tp


@pytest.mark.parametrize("clip", ["value", "norm", "global", "global_mask"])
def test_clip_pairs_match_jax(clip):
    mask = [True, False, True] if clip == "global_mask" else None
    arrays, jp, tp = _pairs(1, mask)
    make = {"value": lambda m: m.ClipGradByValue(1.0, min=-0.5),
            "norm": lambda m: m.ClipGradByNorm(2.0),
            "global": lambda m: m.ClipGradByGlobalNorm(3.0),
            "global_mask": lambda m: m.ClipGradByGlobalNorm(3.0)}[clip]
    jout = make(pt.nn)([(p, Tensor(jnp.asarray(a)))
                        for p, a in zip(jp, arrays)] + [(jp[0], None)])
    tout = make(tnn)([(p, torch.from_numpy(a))
                      for p, a in zip(tp, arrays)] + [(tp[0], None)])
    assert tout[-1][1] is None and jout[-1][1] is None
    for (_, jg), (_, tg) in zip(jout[:-1], tout[:-1]):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg._data),
                                   rtol=0, atol=1e-6)
    if mask:
        assert torch.equal(tout[1][1], torch.from_numpy(arrays[1]))


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_matches_jax(norm_type):
    arrays, jp, tp = _pairs(2)
    for a, jx, tx in zip(arrays, jp, tp):
        jx.grad = Tensor(jnp.asarray(a * 3))
        tx.grad = torch.from_numpy(a * 3)
    jtotal = jclip.clip_grad_norm_(jp, 4.0, norm_type=norm_type)
    ttotal = tnn.clip_grad_norm_(tp, 4.0, norm_type=norm_type)
    np.testing.assert_allclose(ttotal.item(), float(jtotal._data),
                               rtol=1e-6)
    for jx, tx in zip(jp, tp):
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad._data),
                                   rtol=0, atol=1e-6)
    tp[0].grad[0, 0] = float("nan")
    with pytest.raises(RuntimeError, match="non-finite"):
        tnn.clip_grad_norm_(tp, 4.0, error_if_nonfinite=True)


def test_clip_grad_value_matches_jax():
    arrays, jp, tp = _pairs(3)
    for a, jx, tx in zip(arrays, jp, tp):
        jx.grad = Tensor(jnp.asarray(a))
        tx.grad = torch.from_numpy(a.copy())
    jclip.clip_grad_value_(jp, 0.7)
    tnn.clip_grad_value_(tp, 0.7)
    for jx, tx in zip(jp, tp):
        np.testing.assert_array_equal(tx.grad.numpy(),
                                      np.asarray(jx.grad._data))


# -- the slice: a scheduled, clipped GPT step ------------------------------------

NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
SLICE_STEPS, SLICE_LR = 6, 1e-3


def _slice_schedule(m):
    return m.LinearWarmup(m.CosineAnnealingDecay(SLICE_LR, T_max=6),
                          warmup_steps=2, start_lr=0.0, end_lr=SLICE_LR)


def test_scheduled_clipped_gpt_step_matches_jax():
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 1024, (2, 64)).astype(np.int32)
    labels = rng.randint(0, 1024, (2, 64)).astype(np.int32)
    pt.seed(0)
    jmodel = jgpt.GPTForCausalLM(
        jgpt.gpt_tiny(tensor_parallel=False, **NO_DROPOUT))
    arrays = {k: np.asarray(p._data) for k, p in jmodel.named_parameters()}
    jsched = _slice_schedule(jlr)
    jopt = pt.optimizer.AdamW(learning_rate=jsched,
                              parameters=jmodel.parameters(),
                              grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    crit = jgpt.GPTPretrainingCriterion()

    def loss_of(p):
        out, _ = functional_call(jmodel, p, {}, (Tensor(ids),),
                                 training=True, forward_fn=jmodel.forward)
        return crit(out, Tensor(labels))._data.astype(jnp.float32)

    @jax.jit
    def jstep(params, state, lr):
        loss, grads = jax.value_and_grad(loss_of)(params)
        params, state = jopt.apply_gradients_tree(params, grads, state,
                                                  lr=lr)
        return loss, params, state

    params = {k: p._data for k, p in jmodel.named_parameters()}
    state = jopt.init_state_tree(params)
    jlosses = []
    for _ in range(SLICE_STEPS):
        loss, params, state = jstep(params, state, jnp.float32(jsched()))
        jlosses.append(float(loss))
        jsched.step()

    model = GPTForCausalLM(gpt_tiny(**NO_DROPOUT),
                           generator=make_generator(0, "cpu"))
    params_from_numpy(model, arrays)
    tsched = _slice_schedule(tlr)
    opt = AdamW(learning_rate=tsched,
                grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    step = train.TrainStep(model, GPTPretrainingCriterion(), opt,
                           make_generator(0, "cpu"))
    losses, lrs = [], []
    for _ in range(SLICE_STEPS):
        losses.append(step(torch.from_numpy(ids).long(),
                           torch.from_numpy(labels).long()).item())
        lrs.append((opt.lr_tensor.item(), np.float32(tsched())))
        tsched.step()
    assert step.captured.stats["fallback"] == "cpu"
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-5)
    assert all(got == want for got, want in lrs)
    assert lrs[0][0] == 0.0 and len({g for g, _ in lrs}) > 3
    assert losses[-1] < losses[1]
    assert int(step.state["step"]) == int(state["step"]) == SLICE_STEPS


def test_builders_take_an_optimizer():
    opt = SGD(learning_rate=tlr.StepDecay(0.1, 2))
    step = train.build_train_step(gpt_tiny(**NO_DROPOUT), device="cpu",
                                  amp_o2=False, optimizer=opt)
    assert step.optimizer is opt and opt.lr_tensor.item() == np.float32(0.1)
    default = train.build_train_step(gpt_tiny(), device="cpu", amp_o2=False)
    assert isinstance(default.optimizer, AdamW)
    assert default.optimizer.get_lr() == 1e-4


# -- L-BFGS ------------------------------------------------------------------------

def _quadratic():
    rs = np.random.RandomState(0)
    return (rs.randn(12, 6).astype(np.float32),
            rs.randn(12).astype(np.float32))


def _lbfgs_jax(a, b, **kw):
    A, B = pt.to_tensor(a), pt.to_tensor(b)
    x = pt.to_tensor(np.zeros(6, np.float32), stop_gradient=False)
    opt = pt.optimizer.LBFGS(parameters=[x], **kw)

    def closure():
        loss = ((pt.matmul(A, x) - B) ** 2).sum()
        loss.backward()
        return loss
    first = float(opt.step(closure).item())
    return x.numpy(), first, opt


def _lbfgs_port(a, b, **kw):
    A, B = torch.from_numpy(a), torch.from_numpy(b)
    x = torch.nn.Parameter(torch.zeros(6))
    opt = LBFGS(parameters=[x], **kw)

    def closure():
        loss = ((A @ x - B) ** 2).sum()
        loss.backward()
        return loss
    first = float(opt.step(closure).item())
    return x.detach().numpy(), first, opt


@pytest.mark.parametrize("line_search", ["strong_wolfe", None])
def test_lbfgs_matches_jax_on_the_quadratic(line_search):
    a, b = _quadratic()
    kw = dict(max_iter=20, line_search_fn=line_search)
    if line_search is None:
        kw["learning_rate"] = 0.05
    jx, jfirst, _ = _lbfgs_jax(a, b, **kw)
    tx, tfirst, opt = _lbfgs_port(a, b, **kw)
    assert abs(tfirst - jfirst) <= 1e-5 * abs(jfirst)

    def loss64(x):
        r = a.astype(np.float64) @ x.astype(np.float64) - b
        return float(r @ r)
    assert abs(loss64(tx) - loss64(jx)) <= 1e-5 * loss64(jx)
    if line_search:
        # both end on the f32 noise floor of the loss, where a last-bit
        # difference steers the search: the solutions agree to the JAX
        # test's 1e-3 of the least-squares solution, the losses to 1e-5
        x_star = np.linalg.lstsq(a.astype(np.float64), b.astype(np.float64),
                                 rcond=None)[0]
        for x in (tx, jx):
            np.testing.assert_allclose(x, x_star, atol=1e-3, rtol=1e-3)
        assert loss64(tx) <= loss64(x_star) * (1 + 1e-5)
    else:
        np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-5)
    sd = opt.state_dict()
    _, _, jopt = _lbfgs_jax(a, b, **kw)
    assert set(sd) == set(jopt.state_dict()) == {"global_step", "lbfgs"}
    assert set(sd["lbfgs"]) == set(jopt.state_dict()["lbfgs"])
    other = LBFGS(parameters=[torch.nn.Parameter(torch.zeros(6))], **kw)
    other.set_state_dict(sd)
    assert "lbfgs" in sd and len(other._hist_s) == len(opt._hist_s)
    for got, want in zip(other._hist_s, opt._hist_s):
        assert torch.equal(got, want)
    assert other._rho == opt._rho and not other._first_iter


def test_lbfgs_refuses_decay_clip_and_unknown_search():
    x = torch.nn.Parameter(torch.ones(2))
    with pytest.raises(NotImplementedError):
        LBFGS(parameters=[x], weight_decay=0.1)
    with pytest.raises(NotImplementedError):
        LBFGS(parameters=[x], grad_clip=tnn.ClipGradByValue(1.0))
    with pytest.raises(ValueError):
        LBFGS(parameters=[x], line_search_fn="armijo")
    with pytest.raises(ValueError):
        LBFGS(parameters=[x]).step()
