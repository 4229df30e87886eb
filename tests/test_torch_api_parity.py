"""The port's public signatures against the JAX package's, where a
signature scan over the module paths the two share found them apart, and
what each added argument does.

 - Every optimizer's constructor takes the JAX class's parameter names in
   the JAX order (``parameters`` second for ``Optimizer`` and ``SGD``,
   third for ``Momentum``, fifth for the Adam family), and a positional
   construction in that order gives the keyword construction's state;
   ``Momentum(0.1, 0.9, params)`` updates by heavy-ball momentum.
 - ``amp.decorate(models, optimizers=None, level, dtype, master_weight,
   save_dtype)`` and ``amp_decorate``: one model, a list, ``(models,
   optimizers)``; anything but O2 bf16 raises naming ROADMAP item 9.
 - ``GPTPretrainingCriterion(cfg)`` with ``forward(logits, labels,
   loss_mask)``: the JAX criterion's loss within ``LOSS_TOL``, masked and
   not, on whole logits and over 2 model-parallel gloo ranks.
 - The reference's names on ``F.dropout`` (``axis``, ``mode``, ``name``),
   ``F.flash_attention`` (``fixed_seed_offset``, ``rng_name``),
   ``F.embedding`` / ``nn.Embedding`` (``sparse``: True raises by name),
   ``name`` on six functionals, ``isend`` / ``irecv`` (``sync_op``) and
   ``new_group`` (``axis_name``): accepted with the reference's meaning.
"""
import inspect

import numpy as np
import pytest
import torch

from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import fleet, spawn
from paddle_tpu_torch.framework.random import make_generator
from paddle_tpu_torch.incubate.models import GPTPretrainingCriterion, gpt_tiny
from paddle_tpu_torch.nn import functional as F

SPAWN_TIMEOUT = 60
LOSS_TOL = 1e-6
OPTIMIZERS = ("Optimizer", "SGD", "Momentum", "Adagrad", "Adadelta",
              "RMSProp", "Adam", "AdamW", "Adamax", "Lamb", "NAdam", "RAdam")


def _names(fn):
    return [p for p in inspect.signature(fn).parameters if p != "self"]


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_parameter_names_are_the_jax_classes_in_order(name):
    import paddle_tpu.optimizer as jopt
    assert _names(getattr(topt, name).__init__) == \
        _names(getattr(jopt, name).__init__)


def _params():
    return [torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(
        torch.zeros(2, 2))]


def _state(opt):
    out = {}
    for k, v in vars(opt).items():
        if k == "_parameter_list":
            out[k] = [id(p) for p in v]
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_positional_construction_gives_the_keyword_state(name):
    """Every argument by position in the JAX class's order, and by
    keyword: the same optimizer."""
    import paddle_tpu.optimizer as jopt
    cls = getattr(topt, name)
    params = _params()
    sig = inspect.signature(getattr(jopt, name).__init__)
    args, kw = [], {}
    for p in list(sig.parameters.values())[1:]:
        value = params if p.name == "parameters" else (
            0.05 if p.name == "learning_rate" else p.default)
        args.append(value)
        kw[p.name] = value
    pos, key = cls(*args), cls(**kw)
    assert _state(pos) == _state(key)
    assert [id(p) for p in pos._parameter_list] == [id(p) for p in params]


def test_momentum_with_positional_parameters_is_heavy_ball():
    params = _params()
    opt = topt.Momentum(0.1, 0.9, params)
    assert opt._parameter_list == params and opt._nesterov is False
    w = {"w": torch.ones(3)}
    g = {"w": torch.full((3,), 2.0)}
    state = opt.init_state_tree(w)
    opt.apply_gradients_tree(w, g, state)
    opt.apply_gradients_tree(w, g, state)
    # v1 = g, v2 = 0.9 g + g: p = 1 - 0.1 (g + 1.9 g) = 1 - 0.58
    # (Nesterov would give 1 - 0.1 (1.9 g + 2.71 g) = 1 - 0.922)
    torch.testing.assert_close(w["w"], torch.full((3,), 1 - 0.58))


def test_sgd_with_positional_parameters_keeps_them_and_no_decay():
    params = _params()
    opt = topt.SGD(0.1, params)
    assert opt._parameter_list == params and opt._weight_decay == 0.0


@pytest.mark.parametrize("name,kw", [
    ("Adam", {"lazy_mode": True, "use_multi_tensor": True, "name": "a"}),
    ("AdamW", {"lr_ratio": lambda p: 1.0,
               "apply_decay_param_fun": lambda n: True, "lazy_mode": False,
               "name": "w"}),
    ("SGD", {"name": "s"}), ("Momentum", {"name": "m"}),
    ("Lamb", {"name": "l"}), ("RMSProp", {"name": "r",
                                          "learning_rate": 0.1})])
def test_optimizers_accept_the_reference_keywords(name, kw):
    opt = getattr(topt, name)(**kw)
    assert opt._name == kw["name"]


def _two_linears():
    gen = make_generator(0, "cpu")
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.nn.initializer import Normal
    return [Linear(4, 3, Normal(std=0.1), generator=gen) for _ in range(2)]


def test_decorate_takes_models_and_optimizers_as_the_reference_does():
    from paddle_tpu_torch.amp import amp_decorate, decorate
    assert amp_decorate is decorate
    assert _names(decorate) == ["models", "optimizers", "level", "dtype",
                                "master_weight", "save_dtype"]
    a, b = _two_linears()
    assert decorate(models=a) is a
    assert {p.dtype for p in a.parameters()} == {torch.bfloat16}
    opt = topt.AdamW(1e-3)
    models, opts = decorate(b, opt)
    assert models is b and opts is opt
    assert {p.dtype for p in b.parameters()} == {torch.bfloat16}
    c, d = _two_linears()
    out = decorate([c, d], [opt], level="O2", dtype="bfloat16",
                   master_weight=True, save_dtype="float32")
    assert out[0] == [c, d] and out[1] == [opt]
    assert {p.dtype for m in (c, d) for p in m.parameters()} == \
        {torch.bfloat16}


@pytest.mark.parametrize("kw", [{"level": "O1"}, {"dtype": "float16"}],
                         ids=["O1", "fp16"])
def test_decorate_outside_o2_bf16_raises_naming_the_roadmap(kw):
    from paddle_tpu_torch.amp import decorate
    with pytest.raises(NotImplementedError, match="item 9"):
        decorate(_two_linears()[0], **kw)


def test_decorate_matches_the_jax_signature():
    import paddle_tpu.amp as jamp
    from paddle_tpu_torch.amp import decorate
    assert _names(decorate) == _names(jamp.decorate)


# -- the GPT criterion -----------------------------------------------------------

V, BS = 64, (2, 8)


def _criterion_data():
    rng = np.random.RandomState(4)
    logits = rng.standard_normal((*BS, V)).astype(np.float32)
    labels = rng.randint(0, V, BS).astype(np.int64)
    mask = (rng.rand(*BS) > 0.4).astype(np.float32)
    return logits, labels, mask


def _jax_criterion(masked):
    import jax.numpy as jnp
    from paddle_tpu.incubate.models import gpt as jgpt
    from paddle_tpu.tensor import Tensor
    logits, labels, mask = _criterion_data()
    crit = jgpt.GPTPretrainingCriterion(jgpt.gpt_tiny())
    args = [Tensor(jnp.asarray(logits)), Tensor(jnp.asarray(labels))]
    if masked:
        args.append(Tensor(jnp.asarray(mask)))
    return float(np.asarray(crit(*args)._data))


@pytest.mark.parametrize("masked", [False, True], ids=["mean", "masked"])
def test_gpt_criterion_takes_cfg_and_loss_mask_as_jax(masked):
    logits, labels, mask = _criterion_data()
    crit = GPTPretrainingCriterion(gpt_tiny())
    args = [torch.from_numpy(logits), torch.from_numpy(labels)]
    if masked:
        args.append(torch.from_numpy(mask))
    got = crit(*args)
    assert abs(got.item() - _jax_criterion(masked)) <= LOSS_TOL
    assert _names(GPTPretrainingCriterion.forward) == \
        ["logits", "labels", "loss_mask"]


def test_gpt_criterion_empty_mask_divides_by_the_floor():
    logits, labels, mask = _criterion_data()
    got = GPTPretrainingCriterion()(torch.from_numpy(logits),
                                    torch.from_numpy(labels),
                                    torch.zeros(BS))
    assert got.item() == 0.0


def _mp_rank(data):
    tdist.init_parallel_env(device="cpu")
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"mp_degree": 2}
    fleet.init(is_collective=True, strategy=s)
    r = fleet.get_hybrid_communicate_group().get_model_parallel_rank()
    logits, labels, mask = data
    crit = GPTPretrainingCriterion(gpt_tiny())
    local = torch.from_numpy(np.ascontiguousarray(
        np.split(logits, 2, axis=-1)[r]))
    out = {"mean": crit(local, torch.from_numpy(labels)).item(),
           "masked": crit(local, torch.from_numpy(labels),
                          torch.from_numpy(mask)).item()}
    # point to point with sync_op, and a group's axis name
    g = tdist.new_group([0, 1], axis_name="sep")
    peer = 1 - tdist.get_rank()
    got = torch.zeros(3)
    send = tdist.isend(torch.full((3,), float(r + 1)), dst=peer, group=g,
                       sync_op=False)
    tdist.irecv(got, src=peer, group=g, sync_op=True)
    send.wait()
    out["axis_name"], out["got"] = g.axis_name, got.tolist()
    return out


def test_gpt_criterion_over_two_model_parallel_ranks_matches_jax(tmp_path):
    ranks = spawn(_mp_rank, args=(_criterion_data(),), nprocs=2,
                  store=str(tmp_path / "store"), timeout=SPAWN_TIMEOUT)
    for r, res in enumerate(ranks):
        for key, masked in (("mean", False), ("masked", True)):
            assert abs(res[key] - _jax_criterion(masked)) <= LOSS_TOL, key
        assert res["axis_name"] == "sep"
        assert res["got"] == [2.0 - r] * 3


# -- the rest of the scan --------------------------------------------------------

FUNCTIONALS = ["dropout", "linear", "gelu", "tanh", "layer_norm",
               "cross_entropy", "scaled_dot_product_attention", "embedding"]


@pytest.mark.parametrize("name", FUNCTIONALS)
def test_functional_takes_the_jax_names_in_order(name):
    import paddle_tpu.nn.functional as JF
    want = _names(getattr(JF, name))
    assert _names(getattr(F, name))[:len(want)] == want


def test_flash_attention_and_collectives_take_the_jax_names():
    import paddle_tpu.distributed as JD
    from paddle_tpu.nn.functional import flash_attention as jfa
    want = _names(jfa.flash_attention)
    assert _names(F.flash_attention)[:len(want)] == want
    for name in ("isend", "irecv", "new_group"):
        assert _names(getattr(tdist, name)) == _names(getattr(JD, name))


def test_functionals_accept_name():
    x = torch.randn(2, 4)
    w = torch.randn(4, 3)
    F.linear(x, w, name="fc")
    F.gelu(x, name="g")
    F.tanh(x, name="t")
    F.layer_norm(x, 4, name="ln")
    F.cross_entropy(torch.randn(2, 5), torch.tensor([1, 2]), name="ce")
    q = torch.randn(1, 4, 2, 8)
    F.scaled_dot_product_attention(q, q, q, name="sdpa")
    F.embedding(torch.tensor([0, 1]), w, name="emb")


def test_dropout_axis_and_downscale_in_infer():
    x = torch.ones(6, 5)
    gen = make_generator(2, "cpu")
    # the third positional argument is axis, as in the reference
    y = F.dropout(x, 0.5, 0, True, generator=gen)
    assert torch.all(y == y[:, :1])              # one draw a row
    assert set(y.unique().tolist()) <= {0.0, 2.0}
    assert F.dropout(x, 0.5, None, False) is x
    torch.testing.assert_close(
        F.dropout(x, 0.25, training=False, mode="downscale_in_infer"),
        x * 0.75)
    z = F.dropout(x, 0.25, training=True, mode="downscale_in_infer",
                  generator=gen)
    assert set(z.unique().tolist()) <= {0.0, 1.0}
    with pytest.raises(ValueError, match="mode"):
        F.dropout(x, 0.25, mode="bogus")


def test_flash_attention_fixed_seed_offset_and_rng_name():
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        get_rng_state_tracker
    from paddle_tpu_torch.ops import pallas_ops
    q = torch.randn(1, 64, 2, 16)
    a, _ = F.flash_attention(q, q, q, 0.1, True,
                             fixed_seed_offset=torch.tensor([7, 0]))
    b, _ = F.flash_attention(q, q, q, 0.1, True, fixed_seed_offset=7)
    want = pallas_ops.mha(q.transpose(1, 2), q.transpose(1, 2),
                          q.transpose(1, 2), causal=True, dropout_p=0.1,
                          seed=7).transpose(1, 2)
    assert torch.equal(a, b) and torch.equal(a, want)
    with pytest.raises(KeyError, match="no_such_rng"):
        F.flash_attention(q, q, q, 0.1, rng_name="no_such_rng")
    tracker = get_rng_state_tracker()
    tracker.reset()
    try:
        tracker.add("attn_rng", 3, "cpu")
        c, _ = F.flash_attention(q, q, q, 0.1, rng_name="attn_rng")
        d, _ = F.flash_attention(q, q, q, 0.1,
                                 generator=make_generator(3, "cpu"))
        assert torch.equal(c, d)
    finally:
        tracker.reset()


def test_sparse_embedding_raises_by_name():
    from paddle_tpu_torch.nn import Embedding
    from paddle_tpu_torch.nn.initializer import Normal
    w = torch.randn(5, 3)
    ids = torch.tensor([1, 4])
    torch.testing.assert_close(F.embedding(ids, w, sparse=False), w[ids])
    with pytest.raises(NotImplementedError, match="sparse"):
        F.embedding(ids, w, sparse=True)
    with pytest.raises(NotImplementedError, match="sparse"):
        Embedding(5, 3, Normal(), generator=make_generator(0, "cpu"),
                  sparse=True)


# -- the checkpoint calls in the reference's order ------------------------------------

def _ckpt_state():
    return {"params": {"w": torch.arange(24, dtype=torch.float32).reshape(
        4, 6)}, "opt_tree": {"step": torch.tensor(3, dtype=torch.int32)}}


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("fn", ["checkpoint:load_sharded",
                                "checkpoint_manager:CheckpointManager."
                                "restore_latest",
                                "fleet.fleet:Fleet.save_sharded",
                                "fleet.fleet:Fleet.load_sharded"])
def test_checkpoint_calls_take_the_jax_names_in_order(fn):
    import importlib
    mod, attrs = fn.split(":")
    objs = []
    for pkg in ("paddle_tpu.distributed", "paddle_tpu_torch.distributed"):
        obj = importlib.import_module(f"{pkg}.{mod}")
        for a in attrs.split("."):
            obj = getattr(obj, a)
        objs.append(obj)
    want, got = (_names(o) for o in objs)
    # the port's device choice is keyword-only, after the JAX arguments
    assert [n for n in got if n != "device"] == want


def test_load_sharded_binds_mesh_shardings_template_by_position(tmp_path):
    """``load_sharded(path, mesh, shardings, template)`` as a reference
    call writes it: the mesh places each leaf (rank 0 of dp 2 takes rows
    0-1 under ``("dp", None)``), the template chooses the leaves."""
    from paddle_tpu_torch.distributed import build_mesh, checkpoint
    path = str(tmp_path / "c")
    checkpoint.save_sharded(_ckpt_state(), path)
    mesh = build_mesh({"dp": 2}, world_size=2)
    got = checkpoint.load_sharded(path, mesh, None, _zeros_like(
        _ckpt_state()))
    torch.testing.assert_close(got["params"]["w"],
                               _ckpt_state()["params"]["w"])
    got = checkpoint.load_sharded(path, mesh, {"params.w": ("dp", None)})
    torch.testing.assert_close(got["params"]["w"],
                               _ckpt_state()["params"]["w"][:2])
    assert int(got["opt_tree"]["step"]) == 3


def test_restore_latest_binds_template_mesh_by_position(tmp_path):
    from paddle_tpu_torch.distributed import CheckpointManager, build_mesh
    mgr = CheckpointManager(str(tmp_path / "run"))
    mgr.save(5, _ckpt_state())
    tmpl = _zeros_like(_ckpt_state())
    tree, n = mgr.restore_latest(tmpl, build_mesh({"dp": 1}, world_size=1),
                                 None)
    assert n == 5
    torch.testing.assert_close(tree["params"]["w"],
                               _ckpt_state()["params"]["w"])


def test_fleet_save_and_load_sharded_round_trip(tmp_path):
    path = str(tmp_path / "f")
    fleet.fleet.save_sharded(_ckpt_state(), path)
    state = _zeros_like(_ckpt_state())
    assert fleet.fleet.load_sharded(path, state) is state
    torch.testing.assert_close(state["params"]["w"],
                               _ckpt_state()["params"]["w"])
    # a train step: its tree in, its live tensors restored in place
    from paddle_tpu_torch.train import build_train_step, make_batch
    cfg = gpt_tiny()
    ids, labels = make_batch(cfg, 2, 16, device="cpu")
    a = build_train_step(cfg, device="cpu", amp_o2=False, fusion=False)
    a(ids, labels)
    fleet.fleet.save_sharded(a, str(tmp_path / "s"))
    b = build_train_step(cfg, device="cpu", amp_o2=False, fusion=False,
                         seed=1)
    w = b.params["gpt.layers.0.attn.qkv_proj.weight"]
    assert fleet.fleet.load_sharded(str(tmp_path / "s"), b) is b
    assert b.params["gpt.layers.0.attn.qkv_proj.weight"] is w
    for n, p in a.params.items():
        assert torch.equal(p, b.params[n]), n
    assert a(ids, labels).item() == b(ids, labels).item()
