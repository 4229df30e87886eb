"""Data x tensor parallelism in the port, on the CPU over gloo ranks,
held to the JAX package.

 - Topology: ``CommunicateTopology``'s rank arithmetic and
   ``fleet.init``'s degrees against the JAX package's, in this process;
   the gradient bucket plan against the JAX ``partition_buckets``.
 - The mp layers at mp 2 and 4 (four gloo ranks, one spawn): outputs and
   the gradients of inputs and of the gathered weights within
   ``LAYER_TOL`` of the JAX layers in dense mode on the whole weights
   (``tests/test_distributed.py``'s manual-vs-dense checks).  The same
   spawn builds a ``HybridCommunicateGroup`` for each four-rank topology
   of ``HCG_DIMS``: each rank's queries and groups are the JAX class's
   for that rank.
 - The slice: ``gpt_tiny`` in f32 with dropout 0 at dp 2 x mp 2 (four
   ranks), three ``AdamW`` steps at ``tests/test_gpt_hybrid.py``'s rate
   (1e-3) with a global-norm clip that bites: losses and
   ``gather_params`` of the updated weights within ``SLICE_TOL`` of the
   JAX package's ``build_train_step`` on a ``{"dp": 2, "mp": 2}`` mesh
   of four of the eight CPU devices (that test's tolerance, about a
   fifteenth of the 3e-3 that three steps move a weight); each tensor's
   update (updated minus initial weights) within ``UPDATE_RTOL`` of the
   JAX update in 2-norm, so a shard left as it was (relative error about
   0.7) or moved the wrong way (2) fails; the two dp ranks' shards the
   same bits; the clip's global norm over the shards, read from the
   clip's ``last_norm`` after each step, within 1e-5 of the JAX norm
   (AdamW's update hides a wrong clip scale).
 - Degree 1: the step at dp = mp = 1 through ``fleet`` gives the
   single-card ``TrainStep``'s losses and weights, dropout 0.1 included
   (at one rank both dropout streams are the run's generator).
 - The dropout streams at mp 2, dropout 0.1: the replicated activations
   (embeddings, every block's output, the final LayerNorm) and the
   replicated parameters the same bits on both mp ranks, the
   attention-probability masks different; with recompute (both streams
   replayed) the same losses.
 - The CLI: ``python -m paddle_tpu_torch.train --dp 2 --mp 2`` on the
   CPU spawns its four ranks and runs.
 - ``DataParallel`` over 2 ranks, a bucket a parameter: the parameters
   broadcast from rank 0, each gradient the mean of the ranks' (the
   same bits on both), and after ``no_sync`` the accumulated sums
   averaged.

Each spawn is bounded by ``SPAWN_TIMEOUT`` seconds and uses a file store
under ``tmp_path``.  The ranks' functions import neither JAX nor the
JAX package: JAX is imported inside the tests.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.distributed import fleet, spawn, unwrap_model
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding)
from paddle_tpu_torch.framework.random import make_generator
from paddle_tpu_torch.incubate.models import (gather_params, gpt_tiny,
                                              params_from_numpy, split_axes)

QKV = "gpt.layers.0.attn.qkv_proj.weight"
SPAWN_TIMEOUT = 60
LAYER_TOL = 1e-5
SLICE_TOL = 2e-4
UPDATE_RTOL = 1e-2
LR, CLIP, STEPS = 1e-3, 0.5, 3
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
B, S = 4, 32


def _batch():
    rng = np.random.RandomState(3)
    return (rng.randint(0, 1024, (B, S)).astype(np.int64),
            rng.randint(0, 1024, (B, S)).astype(np.int64))


# -- topology (no spawn) ---------------------------------------------------------

NAMES = ("data", "pipe", "sharding", "sep", "model")
DIMS = [(2, 1, 1, 1, 2), (1, 2, 1, 1, 4), (2, 2, 1, 1, 2), (8, 1, 1, 1, 1),
        (1, 1, 2, 2, 2), (1, 1, 1, 2, 1), (2, 1, 1, 2, 1), (1, 1, 1, 4, 2),
        (2, 1, 2, 2, 1)]
# the four-rank topologies whose groups the layers' spawn builds
HCG_DIMS = [(2, 1, 1, 1, 2), (1, 2, 1, 1, 2), (1, 1, 2, 1, 2),
            (1, 1, 1, 2, 2)]
HCG_QUERIES = ("get_data_parallel_rank", "get_data_parallel_world_size",
               "get_model_parallel_rank", "get_model_parallel_world_size",
               "get_stage_id", "get_pipe_parallel_world_size",
               "get_sharding_parallel_rank", "get_sep_parallel_rank",
               "get_parallel_mode", "get_global_rank",
               "get_data_parallel_group_src_rank",
               "get_model_parallel_group_src_rank", "is_first_stage",
               "is_last_stage")
HCG_GROUPS = ("get_data_parallel_group", "get_model_parallel_group",
              "get_pipe_parallel_group", "get_sharding_parallel_group")


@pytest.fixture
def jax_dist():
    import paddle_tpu.distributed as jdist
    yield jdist
    jdist.set_mesh(None)
    jdist.destroy_process_group()


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: "x".join(map(str, d)))
def test_topology_rank_arithmetic_matches_jax(dims, jax_dist):
    jt = jax_dist.CommunicateTopology(NAMES, dims)
    pt = tdist.CommunicateTopology(NAMES, dims)
    assert pt.world_size() == jt.world_size()
    for r in range(pt.world_size()):
        assert pt.get_coord(r) == jt.get_coord(r)
        assert pt.get_rank(**dict(zip(NAMES, pt.get_coord(r)))) == r
        for axis in NAMES:
            assert pt.get_rank_from_stage(r, **{axis: 0}) == \
                jt.get_rank_from_stage(r, **{axis: 0})
    for name in NAMES:
        assert pt.get_dim(name) == jt.get_dim(name)
        assert pt.get_comm_list(name) == jt.get_comm_list(name)
        for i in range(pt.get_dim(name)):
            assert pt.get_axis_list(name, i) == jt.get_axis_list(name, i)


@pytest.mark.parametrize("configs", [
    {"dp_degree": 2, "mp_degree": 2, "pp_degree": 2}, {"mp_degree": 2},
    {"mp_degree": 4}, {}, {"dp_degree": 1, "mp_degree": 8},
    {"sharding_degree": 2, "mp_degree": 2}, {"sep_degree": 2},
    {"sep_degree": 2, "mp_degree": 2, "sharding_degree": 2}], ids=str)
def test_fleet_degrees_match_jax_fleet_init(configs, jax_dist, monkeypatch):
    import paddle_tpu.distributed.fleet as jfleet
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "8")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = dict(configs)
    jfleet.init(is_collective=True, strategy=strategy)
    jh = jfleet.get_hybrid_communicate_group()
    want = (jh.get_data_parallel_world_size(),
            jh.get_pipe_parallel_world_size(),
            jh.get_sharding_parallel_world_size(),
            jh.get_sep_parallel_world_size(),
            jh.get_model_parallel_world_size())
    assert fleet.hybrid_degrees(configs, 8) == want
    ps = fleet.DistributedStrategy()
    ps.hybrid_configs = dict(configs)
    assert ps.hybrid_configs == strategy.hybrid_configs
    assert ps.fuse_grad_size_in_MB == strategy.fuse_grad_size_in_MB == 32
    with pytest.raises(ValueError, match="unknown"):
        ps.hybrid_configs = {"bogus_degree": 2}


def test_bucket_plan_matches_jax_partition_buckets(monkeypatch):
    import ml_dtypes
    from paddle_tpu.distributed.grad_buckets import \
        partition_buckets as jax_partition
    from paddle_tpu_torch.distributed.grad_buckets import (
        default_bucket_bytes, partition_buckets)
    shapes = {"a": ((64, 32), "f"), "b": ((32,), "f"), "c": ((128, 64), "h"),
              "d": ((64,), "h"), "e": ((256, 256), "f"), "g": ((7,), "f")}
    np_dt = {"f": np.float32, "h": ml_dtypes.bfloat16}
    t_dt = {"f": torch.float32, "h": torch.bfloat16}
    arrays = {k: np.zeros(s, np_dt[d]) for k, (s, d) in shapes.items()}
    tensors = {k: torch.zeros(s, dtype=t_dt[d]) for k, (s, d) in
               shapes.items()}
    for target in (1, 10_000, 40_000, 1 << 20):
        want = jax_partition(arrays, target)
        got = partition_buckets(tensors, target)
        assert [(b.names, b.sizes, b.nbytes) for b in got.buckets] == \
            [(b.names, b.sizes, b.nbytes) for b in want.buckets], target
    monkeypatch.setenv("PT_GRAD_BUCKET_MB", "2")
    assert default_bucket_bytes(32) == 2 << 20
    monkeypatch.delenv("PT_GRAD_BUCKET_MB")
    assert default_bucket_bytes(None) == 32 << 20


# -- the mp layers (one spawn of 4 ranks) -----------------------------------------

def _layer_data():
    rng = np.random.RandomState(7)
    f = np.float32
    return {
        "col_w": rng.randn(16, 32).astype(f) * 0.2,
        "col_b": rng.randn(32).astype(f) * 0.1,
        "row_w": rng.randn(16, 12).astype(f) * 0.2,
        "row_b": rng.randn(12).astype(f) * 0.1,
        "emb_w": rng.randn(32, 8).astype(f),
        "x": rng.randn(4, 16).astype(f),
        "col_cot": rng.randn(4, 32).astype(f),
        "row_cot": rng.randn(4, 12).astype(f),
        "ids": rng.randint(0, 32, (5, 3)).astype(np.int64),
        "emb_cot": rng.randn(5, 3, 8).astype(f),
        "logits": (rng.rand(6, 16) * 4).astype(f),
        "labels": np.array([3, 15, 0, -100, 8, 12], np.int64),
    }


def _run_layer(layer, x, cot):
    x = torch.from_numpy(x).requires_grad_(x.dtype == np.float32)
    out = layer(x)
    (out * torch.from_numpy(cot)).sum().backward()
    grads = {n: p.grad.numpy() for n, p in layer.named_parameters()}
    return {"out": out.detach().numpy(),
            "dx": None if x.grad is None else x.grad.numpy(), **grads}


def _layers_rank(d):
    tdist.init_parallel_env(device="cpu")
    me = tdist.get_rank()
    pairs = [tdist.new_group([0, 1]), tdist.new_group([2, 3])]
    gen = make_generator(0, "cpu")
    res = {}
    for n, g in ((4, tdist.get_group(0)), (2, pairs[me // 2])):
        r = g.rank

        def load(layer, **arrays):
            return params_from_numpy(layer, arrays, mp_rank=r, mp_degree=n)

        def part(a, axis=-1):
            return np.split(a, n, axis=axis)[r]

        for gather in (True, False):
            col = load(ColumnParallelLinear(16, 32, generator=gen,
                                            gather_output=gather, mp_group=g),
                       weight=d["col_w"], bias=d["col_b"])
            res[n, "col", gather] = _run_layer(
                col, d["x"], d["col_cot"] if gather else part(d["col_cot"]))
        for parallel in (False, True):
            row = load(RowParallelLinear(16, 12, generator=gen,
                                         input_is_parallel=parallel,
                                         mp_group=g),
                       weight=d["row_w"], bias=d["row_b"])
            res[n, "row", parallel] = _run_layer(
                row, part(d["x"]) if parallel else d["x"], d["row_cot"])
        emb = load(VocabParallelEmbedding(32, 8, generator=gen, mp_group=g),
                   weight=d["emb_w"])
        res[n, "emb"] = _run_layer(emb, d["ids"], d["emb_cot"])
        logits = torch.from_numpy(part(d["logits"])).requires_grad_()
        loss = ParallelCrossEntropy(mp_group=g)(
            logits, torch.from_numpy(d["labels"]))
        loss.sum().backward()
        res[n, "ce"] = {"out": loss.detach().numpy(),
                        "dx": logits.grad.numpy()}
    for dims in HCG_DIMS:
        hcg = tdist.HybridCommunicateGroup(
            tdist.CommunicateTopology(NAMES, dims))
        res["hcg", dims] = {
            **{q: getattr(hcg, q)() for q in HCG_QUERIES},
            **{q: (getattr(hcg, q)().ranks, getattr(hcg, q)().rank)
               for q in HCG_GROUPS},
            "mesh": dict(hcg.mesh.shape), "mesh_mp": hcg.mesh.coords(me)["mp"]}
    return res


@pytest.fixture(scope="module")
def layer_results(tmp_path_factory):
    store = tmp_path_factory.mktemp("layers") / "store"
    return spawn(_layers_rank, args=(_layer_data(),), nprocs=4,
                 store=str(store), timeout=SPAWN_TIMEOUT)


def _jax_dense(layer, params, x, cot, int_input=False):
    """The JAX layer in dense mode: output, d input, d params."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.jit.api import functional_call
    from paddle_tpu.tensor import Tensor

    def f(p, xx):
        out, _ = functional_call(layer, p, {}, (Tensor(xx),))
        return jnp.sum(out._data * cot), out._data

    p = {k: jnp.asarray(v) for k, v in params.items()}
    xx = jnp.asarray(x.astype(np.int32) if int_input else x)
    argnums = (0,) if int_input else (0, 1)
    (_, out), grads = jax.value_and_grad(f, argnums=argnums,
                                         has_aux=True)(p, xx)
    res = {"out": np.asarray(out),
           **{k: np.asarray(v) for k, v in grads[0].items()}}
    if not int_input:
        res["dx"] = np.asarray(grads[1])
    return res


@pytest.fixture(scope="module")
def jax_layers():
    import jax
    import jax.numpy as jnp
    import paddle_tpu.distributed as jdist
    from paddle_tpu.distributed.fleet import meta_parallel as jmp
    from paddle_tpu.tensor import Tensor
    d = _layer_data()
    try:
        out = {
            "col": _jax_dense(jmp.ColumnParallelLinear(16, 32), {
                "weight": d["col_w"], "bias": d["col_b"]}, d["x"],
                d["col_cot"]),
            "row": _jax_dense(jmp.RowParallelLinear(16, 12), {
                "weight": d["row_w"], "bias": d["row_b"]}, d["x"],
                d["row_cot"]),
            "emb": _jax_dense(jmp.VocabParallelEmbedding(32, 8), {
                "weight": d["emb_w"]}, d["ids"], d["emb_cot"],
                int_input=True),
        }
        ce = jmp.ParallelCrossEntropy()

        def f(lg):
            loss = ce(Tensor(lg), Tensor(jnp.asarray(d["labels"],
                                                     jnp.int32)))._data
            return jnp.sum(loss), loss

        (_, loss), dlg = jax.value_and_grad(f, has_aux=True)(
            jnp.asarray(d["logits"]))
        out["ce"] = {"out": np.asarray(loss), "dx": np.asarray(dlg)}
        return out
    finally:
        jdist.set_mesh(None)
        jdist.destroy_process_group()


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=LAYER_TOL, atol=LAYER_TOL,
                               err_msg=what)


def _mp_ranks(n):
    """Global ranks of the first mp group of degree ``n``."""
    return list(range(n))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("gather", [True, False],
                         ids=["gather_output", "local_output"])
def test_column_parallel_linear_matches_jax_dense(layer_results, jax_layers,
                                                  n, gather):
    want = jax_layers["col"]
    res = [layer_results[r][n, "col", gather] for r in _mp_ranks(n)]
    out = res[0]["out"] if gather else np.concatenate(
        [r["out"] for r in res], -1)
    _close(out, want["out"], "out")
    for r in res:
        _close(r["dx"], want["dx"], "dx")
    axes = {"weight": 1, "bias": 0}
    full = gather_params(res, axes)
    _close(full["weight"], want["weight"], "dW")
    _close(full["bias"], want["bias"], "db")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("parallel", [False, True],
                         ids=["split_input", "input_is_parallel"])
def test_row_parallel_linear_matches_jax_dense(layer_results, jax_layers, n,
                                               parallel):
    want = jax_layers["row"]
    res = [layer_results[r][n, "row", parallel] for r in _mp_ranks(n)]
    for r in res:
        _close(r["out"], want["out"], "out")
        _close(r["bias"], want["bias"], "db (whole, after the reduce)")
    dx = np.concatenate([r["dx"] for r in res], -1) if parallel else \
        res[0]["dx"]
    _close(dx, want["dx"], "dx")
    _close(gather_params(res, {"weight": 0})["weight"], want["weight"], "dW")


@pytest.mark.parametrize("n", [2, 4])
def test_vocab_parallel_embedding_matches_jax_dense(layer_results,
                                                    jax_layers, n):
    want = jax_layers["emb"]
    res = [layer_results[r][n, "emb"] for r in _mp_ranks(n)]
    for r in res:
        _close(r["out"], want["out"], "out")
    _close(gather_params(res, {"weight": 0})["weight"], want["weight"], "dW")


@pytest.mark.parametrize("n", [2, 4])
def test_parallel_cross_entropy_matches_jax_dense(layer_results, jax_layers,
                                                  n):
    want = jax_layers["ce"]
    res = [layer_results[r][n, "ce"] for r in _mp_ranks(n)]
    for r in res:
        _close(r["out"], want["out"], "loss")
    _close(np.concatenate([r["dx"] for r in res], -1), want["dx"],
           "d logits")
    assert want["out"][3, 0] == 0.0 and np.all(want["dx"][3] == 0)


@pytest.mark.parametrize("dims", HCG_DIMS,
                         ids=lambda d: "x".join(map(str, d)))
def test_hybrid_communicate_group_matches_jax(layer_results, dims, jax_dist,
                                              monkeypatch):
    jt = jax_dist.CommunicateTopology(NAMES, dims)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", str(jt.world_size()))
    for r, res in enumerate(layer_results):
        monkeypatch.setenv("PADDLE_TRAINER_ID", str(r))
        jh = jax_dist.HybridCommunicateGroup(jt)
        got = res["hcg", dims]
        for q in HCG_QUERIES:
            assert got[q] == getattr(jh, q)(), (q, r)
        for q in HCG_GROUPS:
            jg = getattr(jh, q)()
            assert got[q] == (jg.ranks, jg.rank), (q, r)
        assert got["mesh"] == dict(jh.mesh.shape)
        assert got["mesh_mp"] == jh.get_model_parallel_rank()


def test_second_mp_group_matches_the_first(layer_results):
    for key in [(2, "col", True), (2, "row", False), (2, "emb"), (2, "ce")]:
        a, b = layer_results[0][key], layer_results[2][key]
        for name in a:
            if a[name] is not None:
                np.testing.assert_array_equal(a[name], b[name])


# -- the slice: gpt_tiny at dp 2 x mp 2 against the JAX hybrid step ----------------

def _slice_rank(arrays, batch):
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.train import build_train_step
    tdist.init_parallel_env(device="cpu")
    step = build_train_step(
        gpt_tiny(**NO_DROPOUT), device="cpu", amp_o2=False, dp=2, mp=2,
        capture=False, optimizer=AdamW(learning_rate=LR,
                                       grad_clip=ClipGradByGlobalNorm(CLIP)))
    hcg = fleet.get_hybrid_communicate_group()
    params_from_numpy(step.model, arrays,
                      mp_rank=hcg.get_model_parallel_rank(), mp_degree=2)
    ids, labels = (torch.from_numpy(a) for a in batch)
    losses, norms = [], []
    for _ in range(STEPS):
        losses.append(step(ids, labels).item())
        norms.append(step.optimizer._grad_clip.last_norm.item())
    model = unwrap_model(step.model)
    return {"losses": losses, "norms": norms,
            "mp_rank": hcg.get_model_parallel_rank(),
            "dp_rank": hcg.get_data_parallel_rank(),
            "params": {n: p.detach().numpy().copy()
                       for n, p in model.named_parameters()},
            "axes": split_axes(model),
            "n_buckets": step.model.bucket_plan.n_buckets}


@pytest.fixture(scope="module")
def jax_slice():
    """The JAX hybrid step: initial weights, 3 losses, updated weights,
    and the first step's global gradient norm."""
    import jax
    import jax.numpy as jnp
    import paddle_tpu as pt
    import paddle_tpu.distributed as jdist
    from paddle_tpu.distributed.train_step import build_train_step
    from paddle_tpu.incubate.models import gpt as jgpt
    from paddle_tpu.jit.api import functional_call
    from paddle_tpu.tensor import Tensor
    try:
        pt.seed(0)
        model = jgpt.GPTForCausalLM(jgpt.gpt_tiny(tensor_parallel=True,
                                                  **NO_DROPOUT))
        crit = jgpt.GPTPretrainingCriterion()
        init = {k: np.asarray(p._data) for k, p in model.named_parameters()}
        ids, labels = (a.astype(np.int32) for a in _batch())

        def loss_of(p):
            out, _ = functional_call(model, p, {}, (Tensor(ids),),
                                     training=True)
            return crit(out, Tensor(labels))._data

        grads = jax.grad(loss_of)({k: jnp.asarray(v)
                                   for k, v in init.items()})
        norm = float(jnp.sqrt(sum(jnp.sum(g * g) for g in grads.values())))
        mesh = jdist.init_mesh({"dp": 2, "mp": 2},
                               devices=jax.devices()[:4])
        opt = pt.optimizer.AdamW(learning_rate=LR,
                                 parameters=model.parameters(),
                                 grad_clip=pt.nn.ClipGradByGlobalNorm(CLIP))
        step, state = build_train_step(model, lambda lg, lb: crit(lg, lb),
                                       opt, mesh=mesh)
        losses = []
        for _ in range(STEPS):
            loss, state = step(state, ids, labels)
            losses.append(float(loss))
        return {"init": init, "losses": losses, "norm": norm,
                "params": {k: np.asarray(v)
                           for k, v in state["params"].items()}}
    finally:
        jdist.set_mesh(None)
        jdist.destroy_process_group()


@pytest.fixture(scope="module")
def slice_results(jax_slice, tmp_path_factory):
    store = tmp_path_factory.mktemp("slice") / "store"
    return spawn(_slice_rank, args=(jax_slice["init"], _batch()), nprocs=4,
                 store=str(store), timeout=SPAWN_TIMEOUT)


def test_dp2_mp2_step_matches_the_jax_hybrid_step(jax_slice, slice_results):
    assert jax_slice["norm"] > 2 * CLIP        # the clip bites
    for r in slice_results:
        # AdamW hardly moves when every gradient is scaled alike, so the
        # losses cannot show a wrong clip: its norm over the shards must
        # be the JAX package's over the whole gradient
        norm = r["norms"][0]
        assert abs(norm - jax_slice["norm"]) <= 1e-5 * jax_slice["norm"]
        assert len(set(r["norms"])) == STEPS     # a norm each step
        np.testing.assert_allclose(r["losses"], jax_slice["losses"],
                                   rtol=0, atol=SLICE_TOL)
    assert jax_slice["losses"][-1] < jax_slice["losses"][0]
    by = {(r["dp_rank"], r["mp_rank"]): r for r in slice_results}
    for dp in (0, 1):
        full = gather_params([by[dp, 0]["params"], by[dp, 1]["params"]],
                             by[dp, 0]["axes"])
        assert set(full) == set(jax_slice["params"])
        for name, want in jax_slice["params"].items():
            np.testing.assert_allclose(full[name], want, rtol=0,
                                       atol=SLICE_TOL, err_msg=name)
            assert full[name].shape == jax_slice["init"][name].shape
            moved = want - jax_slice["init"][name]
            err = np.linalg.norm(full[name] - jax_slice["init"][name] - moved)
            assert err <= UPDATE_RTOL * np.linalg.norm(moved), name
    for mp in (0, 1):           # the dp ranks hold the same bits
        for name, a in by[0, mp]["params"].items():
            np.testing.assert_array_equal(a, by[1, mp]["params"][name],
                                          err_msg=name)
    axes = slice_results[0]["axes"]
    assert axes["gpt.embeddings.word_embeddings.weight"] == 0
    assert axes["gpt.layers.0.attn.qkv_proj.weight"] == 1
    assert axes["gpt.layers.0.mlp.fc2.weight"] == 0
    assert axes["gpt.layers.0.mlp.fc2.bias"] is None
    assert slice_results[0]["n_buckets"] >= 1


# -- degree 1 and the dropout streams -----------------------------------------------

def _degree_one_rank(batch):
    from paddle_tpu_torch.train import build_train_step
    tdist.init_parallel_env(device="cpu")
    cfg = gpt_tiny()                               # dropout 0.1
    ids, labels = (torch.from_numpy(a) for a in batch)
    plain = build_train_step(cfg, device="cpu", amp_o2=False, fusion=False)
    want = [plain(ids, labels).item() for _ in range(STEPS)]
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1}
    hyb = build_train_step(cfg, device="cpu", amp_o2=False,
                           strategy=strategy, capture=False)
    got = [hyb(ids, labels).item() for _ in range(STEPS)]
    diff = max((plain.params[n] - p).abs().max().item()
               for n, p in hyb.params.items())
    layer = unwrap_model(hyb.model).gpt.layers[0]
    return {"want": want, "got": got, "param_diff": diff,
            "layers": [type(m).__name__ for m in (layer.attn.qkv_proj,
                                                  layer.mlp.fc2)],
            "split": sorted({getattr(p, "split_axis", None) is not None
                             for p in hyb.params.values()})}


def _streams_rank(batch):
    from paddle_tpu_torch.nn.functional import common
    from paddle_tpu_torch.train import build_train_step
    tdist.init_parallel_env(device="cpu")
    masks, acts = [], []
    plain_dropout = common.dropout

    def recording(x, p=0.5, training=True, generator=None):
        out = plain_dropout(x, p, training=training, generator=generator)
        if x.dim() == 4:                   # attention probabilities
            masks.append(((out != 0) | (x == 0)).numpy())
        return out

    common.dropout = recording
    step = build_train_step(gpt_tiny(), device="cpu", amp_o2=False, mp=2,
                            capture=False)
    model = unwrap_model(step.model)
    for m in [model.gpt.embeddings, *model.gpt.layers, model.gpt.final_ln]:
        m.register_forward_hook(
            lambda mod, inp, out: acts.append(out.detach().numpy().copy()))
    ids, labels = (torch.from_numpy(a) for a in batch)
    losses = [step(ids, labels).item() for _ in range(2)]
    # the sharded checkpoint's windows: the split weight one a rank, the
    # replicated LayerNorm written by mp rank 0 only
    tree = step.checkpoint_tree()
    windows = {n: (w.spec, w.window, w.write) for n, w in
               tree["params"].items() if n in (QKV, "gpt.final_ln.weight")}
    common.dropout = plain_dropout
    # recompute replays both streams: the same losses as without it
    rc = build_train_step(gpt_tiny(use_recompute=True), device="cpu",
                          amp_o2=False, mp=2, capture=False)
    losses_rc = [rc(ids, labels).item() for _ in range(2)]
    return {"losses": losses, "losses_rc": losses_rc, "masks": masks,
            "acts": acts, "windows": windows,
            "replicated": {n: p.detach().numpy().copy()
                           for n, p in model.named_parameters()
                           if getattr(p, "split_axis", None) is None}}


def test_degree_one_step_is_the_single_card_step(tmp_path):
    [res] = spawn(_degree_one_rank, args=(_batch(),), nprocs=1,
                  store=str(tmp_path / "store"), timeout=SPAWN_TIMEOUT)
    np.testing.assert_allclose(res["got"], res["want"], rtol=0, atol=1e-6)
    assert res["param_diff"] <= 1e-6
    # the mp layers, at degree 1: no parameter is a slice
    assert res["layers"] == ["ColumnParallelLinear", "RowParallelLinear"]
    assert res["split"] == [False]


def test_mp_ranks_share_replicated_dropout_and_differ_in_attention(
        tmp_path):
    a, b = spawn(_streams_rank, args=(_batch(),), nprocs=2,
                 store=str(tmp_path / "store"), timeout=SPAWN_TIMEOUT)
    assert a["losses"] == b["losses"]
    np.testing.assert_allclose(a["losses_rc"], a["losses"], rtol=0,
                               atol=1e-6)
    layers = gpt_tiny().num_layers
    assert len(a["acts"]) == len(b["acts"]) == 2 * (layers + 2)
    for x, y in zip(a["acts"], b["acts"]):
        np.testing.assert_array_equal(x, y)
    assert len(a["masks"]) == len(b["masks"]) == 2 * layers
    for x, y in zip(a["masks"], b["masks"]):
        assert x.shape == y.shape
        assert not x.all() and not y.all()       # dropout dropped
        assert not np.array_equal(x, y)          # each rank its own heads'
    assert set(a["replicated"]) == set(b["replicated"])
    for name, x in a["replicated"].items():
        np.testing.assert_array_equal(x, b["replicated"][name],
                                      err_msg=name)
    h = gpt_tiny().hidden_size
    for r, res in enumerate((a, b)):
        spec, window, write = res["windows"][QKV]
        assert (spec, write) == ([None, "mp"], True)
        assert window == [[0, h], [r * 3 * h // 2, (r + 1) * 3 * h // 2]]
        assert res["windows"]["gpt.final_ln.weight"] == \
            ([], [[0, h]], r == 0)


def test_train_cli_spawns_dp_x_mp_ranks(monkeypatch):
    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.train import main
    bounded = distributed.spawn
    monkeypatch.setattr(distributed, "spawn", lambda *a, **kw: bounded(
        *a, timeout=SPAWN_TIMEOUT, **kw))
    assert main(["--model", "gpt_tiny", "--dp", "2", "--mp", "2", "--batch",
                 "4", "--seq", "32", "--steps", "2", "--device", "cpu"]) == 0


def _data_parallel_rank(w, xs):
    from paddle_tpu_torch.distributed import DataParallel
    tdist.init_parallel_env(device="cpu")
    me = tdist.get_rank()
    torch.manual_seed(me)                   # different weights on each rank
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                                torch.nn.Linear(16, 4))
    # 1e-4 MB: every parameter a bucket of its own (the plan's edge)
    dp = DataParallel(model, comm_buffer_size=1e-4)
    start = [p.detach().numpy().copy() for p in model.parameters()]
    x = torch.from_numpy(xs[me])
    (dp(x) * torch.from_numpy(w)).sum().backward()
    synced = [p.grad.numpy().copy() for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    with dp.no_sync():
        (dp(x) * torch.from_numpy(w)).sum().backward()
    local = [p.grad.numpy().copy() for p in model.parameters()]
    (dp(x) * torch.from_numpy(w)).sum().backward()
    accumulated = [p.grad.numpy().copy() for p in model.parameters()]
    return {"start": start, "synced": synced, "local": local,
            "accumulated": accumulated, "buckets": dp.bucket_plan.n_buckets}


def test_data_parallel_buckets_average_and_no_sync_accumulates(tmp_path):
    rng = np.random.RandomState(5)
    w = rng.randn(3, 4).astype(np.float32)
    xs = rng.randn(2, 3, 8).astype(np.float32)
    a, b = spawn(_data_parallel_rank, args=(w, xs), nprocs=2,
                 store=str(tmp_path / "store"), timeout=SPAWN_TIMEOUT)
    assert a["buckets"] == 4
    for x, y in zip(a["start"], b["start"]):   # broadcast from rank 0
        np.testing.assert_array_equal(x, y)
    for i in range(4):
        # the synced gradient is the mean of the two ranks' local ones,
        # the same bits on both ranks
        np.testing.assert_array_equal(a["synced"][i], b["synced"][i])
        np.testing.assert_allclose(a["synced"][i],
                                   (a["local"][i] + b["local"][i]) / 2,
                                   rtol=1e-6, atol=1e-7)
        if i < 3:      # the last bias's gradient, w summed, is the same
            assert not np.allclose(a["local"][i], b["local"][i])
        # after no_sync, the next synced backward averages the sums
        np.testing.assert_allclose(a["accumulated"][i],
                                   a["local"][i] + b["local"][i],
                                   rtol=1e-6, atol=1e-6)
