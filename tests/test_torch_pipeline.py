"""Pipeline parallelism in the port, alone and with ZeRO and tensor
parallelism, on the CPU over gloo ranks, held to the JAX package.

 - Pure, no spawn: ``PipelineLayer``'s segmentation (``segment_parts``,
   ``get_stage_from_index``) against the JAX class on the same
   ``LayerDesc`` list, "uniform" and "layer:Block", at pp 2 and 4
   (``tests/test_pipeline.py:23-55``); the schedule tables for pp in
   {2, 4}, M in {pp, 2 pp, 3} and v in {1, 2}: every pass once on its
   rank, a micro-batch's forward on a stage before its backward there
   and after its forward on the previous stage, its backward after the
   next stage's, at most ``pp - s`` activations held on stage ``s`` at
   v = 1 (1F1B), and the idle share ``1 - microbatch_utilization(M v,
   pp)`` where ``pp | M``.
 - ``PipelineParallel.train_batch`` at pp 2 over the Block stack of
   ``tests/test_pipeline.py`` with a ``SharedLayerDesc`` layer on both
   stages, three SGD steps with a global-norm clip that bites, against
   the JAX ``train_batch`` on a pp 2 mesh: losses, weights, the clip's
   norm (the shared layer counted once; counted on both stages, the
   planted fault, it fails), the shared layer the same bits on both
   stages.
 - GPT at pp 2 (``gpt_tiny`` with 4 layers, f32, dropout 0, three
   ``AdamW(1e-3)`` steps, a clip of 0.5 that bites) with v in {1, 2},
   against the JAX ``build_train_step(pipeline_virtual_stages=v)`` on a
   pp 2 mesh: losses, gathered weights, updates, moments on the matching
   device and the clip norm as ``tests/test_torch_zero.py`` holds them;
   the tied embedding the same bits on both stages after each step.
 - The composition: pp 2 x sharding 2 at ``os_g`` and at ``p_g_os``,
   dp 2 x pp 2 at v = 2 (four ranks each) and mp 2 x pp 2 x sharding 2
   at v = 2 (eight ranks, the dryrun's mesh at n = 8,
   ``__graft_entry__.py:108-119``), against the JAX step on that mesh.
 - Degree 1: pp = sharding = 1 through ``fleet`` with ``os_g`` set is
   ``TrainStep``'s losses and weights, bit for bit, dropout 0.1.
 - Planted faults, each measured to fail its comparison: a micro-batch's
   gradient dropped; the tied gradient not summed.
 - The CLI with ``--pp 2 --sharding 2`` spawns four ranks and runs.

Each spawn is bounded by ``SPAWN_TIMEOUT`` seconds (the eight-rank one
by ``SPAWN_TIMEOUT_8``).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.distributed import fleet, spawn
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    LayerDesc, PipelineLayer, SharedLayerDesc, microbatch_utilization,
    schedule_table)
from paddle_tpu_torch.distributed.fleet.meta_parallel.pipeline_parallel \
    import idle_share, residency
from paddle_tpu_torch.incubate.models import gpt_tiny
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.initializer import Normal

from test_torch_zero import (CLIP, LR, MOMENT_RTOL, NO_DROPOUT, NORM_RTOL,
                             SLICE_TOL, STEPS, UPDATE_RTOL, _batch,
                             _optimizer,
                             check_against_jax, device_shards, load_arrays,
                             rank_result, run_steps)

SPAWN_TIMEOUT = 60
SPAWN_TIMEOUT_8 = 120
LAYERS = 4
WORD = "gpt.embeddings.word_embeddings.weight"


# -- segmentation and the schedule (no spawn) -------------------------------------

class Block(torch.nn.Module):
    def __init__(self, h=32, generator=None):
        super().__init__()
        self.fc = Linear(h, h, Normal(0.1), generator=generator)

    def forward(self, x):
        return torch.tanh(self.fc(x)) + x


def _descs(n_blocks=4, h=32, generator=None, shared=False):
    """The Block stack; ``shared``: a ``SharedLayerDesc`` Linear(h, h)
    after the first layer and again before the last (a tied pair on the
    first and the last stage)."""
    gen = generator or torch.Generator().manual_seed(0)
    tie = [SharedLayerDesc("tie", Linear, None, "weight", h, h, Normal(0.1),
                           generator=gen)] if shared else []
    return ([LayerDesc(Linear, 16, h, Normal(0.1), generator=gen)] + tie +
            [LayerDesc(Block, h, generator=gen) for _ in range(n_blocks)] +
            tie + [LayerDesc(Linear, h, 10, Normal(0.1), generator=gen)])


def _jax_descs(n_blocks=4, h=32, shared=False):
    import paddle_tpu as pt
    from paddle_tpu.distributed.fleet.meta_parallel import LayerDesc as JDesc
    from paddle_tpu.distributed.fleet.meta_parallel import \
        SharedLayerDesc as JShared

    class Block(pt.nn.Layer):
        def __init__(self, h=32):
            super().__init__()
            self.fc = pt.nn.Linear(h, h)

        def forward(self, x):
            return pt.nn.functional.tanh(self.fc(x)) + x

    tie = [JShared("tie", pt.nn.Linear, None, "weight", h, h)] if shared \
        else []
    return ([JDesc(pt.nn.Linear, 16, h)] + tie +
            [JDesc(Block, h) for _ in range(n_blocks)] +
            tie + [JDesc(pt.nn.Linear, h, 10)])


@pytest.mark.parametrize("n_blocks", [4, 6, 8])
@pytest.mark.parametrize("seg", ["uniform", "layer:Block"])
@pytest.mark.parametrize("pp", [2, 4])
def test_segmentation_matches_the_jax_pipeline_layer(pp, seg, n_blocks):
    import paddle_tpu.distributed as jdist
    from paddle_tpu.distributed.fleet.meta_parallel import \
        PipelineLayer as JLayer
    try:
        want = JLayer(_jax_descs(n_blocks), num_stages=pp, seg_method=seg)
        got = PipelineLayer(_descs(n_blocks), num_stages=pp, seg_method=seg)
        assert got.segment_parts == want.segment_parts
        for i in range(n_blocks + 2):
            assert got.get_stage_from_index(i) == \
                want.get_stage_from_index(i), i
        assert got.num_stages == want.num_stages == pp
        assert sorted(n for n, _ in got.named_parameters()) == \
            sorted(n for n, _ in want.named_parameters())
    finally:
        jdist.set_mesh(None)


@pytest.mark.parametrize("v", [1, 2])
@pytest.mark.parametrize("m", ["pp", "2pp", "3"])
@pytest.mark.parametrize("pp", [2, 4])
def test_schedule_tables(pp, m, v):
    M = {"pp": pp, "2pp": 2 * pp, "3": 3}[m]
    table = schedule_table(pp, M, v)
    tick = {}
    for t, row in enumerate(table):
        for s, op in enumerate(row):
            if op is not None:
                assert op not in tick, op
                assert op[2] % pp == s, (op, s)       # on its rank
                tick[op] = t
    K = pp * v
    assert len(tick) == 2 * M * K
    for mb in range(M):
        for k in range(K):
            assert tick["F", mb, k] < tick["B", mb, k]
            if k:
                assert tick["F", mb, k - 1] < tick["F", mb, k]
            if k < K - 1:
                assert tick["B", mb, k + 1] < tick["B", mb, k]
    for s in range(pp):
        if v == 1:
            assert residency(table, s) <= pp - s, (s, residency(table, s))
    if M % pp == 0:
        assert idle_share(table) == pytest.approx(
            1 - microbatch_utilization(M * v, pp), abs=1e-12)
        assert len(table) == 2 * (M * v + pp - 1)


# -- PipelineParallel.train_batch over the Block stack -----------------------------

TIE = "_layer_list.1.weight"          # the shared Linear, named by its first use


def _block_rank(arrays, x, y):
    """Three ``train_batch`` steps of SGD with a global-norm clip over
    the shared Block stack at pp 2, then the same with the shared layer's
    copy on the last stage counted in the clip's norm (the planted
    fault)."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import SGD
    tdist.init_parallel_env(device="cpu")
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"pp_degree": 2}
    s.pipeline_configs = {"accumulate_steps": 4}
    fleet.init(is_collective=True, strategy=s)
    data = (torch.from_numpy(x), torch.from_numpy(y))

    def build():
        layer = PipelineLayer(_descs(shared=True), loss_fn=F.cross_entropy)
        with torch.no_grad():
            for n, p in layer.named_parameters():
                p.copy_(torch.from_numpy(arrays[n]))
        opt = SGD(learning_rate=0.1, grad_clip=ClipGradByGlobalNorm(CLIP))
        return layer, fleet.distributed_model(layer), opt

    def steps(model, opt):
        losses, norms = [], []
        for _ in range(STEPS):
            losses.append(model.train_batch(data, opt).item())
            norms.append(opt._grad_clip.last_norm.item())
        return losses, norms

    layer, model, opt = build()
    losses, norms = steps(model, opt)
    try:
        model.train_batch(data, opt, scaler=object())
    except NotImplementedError as e:
        scaler = str(e)
    out = {"losses": losses, "norms": norms,
           "eval": model.eval_batch(data).item(), "scaler": scaler,
           "type": type(model).__name__,
           "shared": sorted(layer.shared_weights()),
           "params": {n: p.detach().numpy().copy()
                      for n, p in layer.named_parameters()}}
    layer, model, opt = build()
    honest = layer.shared_weights
    layer.shared_weights = lambda: {n: (g, True)
                                    for n, (g, _) in honest().items()}
    out["counted_twice"] = steps(model, opt)[1]
    return out


@functools.lru_cache(maxsize=None)
def _jax_blocks():
    import jax
    import jax.numpy as jnp
    import paddle_tpu as pt
    import paddle_tpu.distributed as jdist
    from paddle_tpu.distributed.fleet.meta_parallel import (
        PipelineLayer as JLayer, PipelineParallel as JParallel)
    from paddle_tpu.jit.api import functional_call
    from paddle_tpu.tensor import Tensor
    rng = np.random.RandomState(1)
    x = rng.randn(8, 16).astype(np.float32)
    y = rng.randint(0, 10, 8).astype(np.int64)
    try:
        jdist.init_mesh({"dp": 1, "pp": 2, "sharding": 1, "sep": 1,
                         "mp": 1}, devices=jax.devices()[:2])
        pt.seed(0)
        layer = JLayer(_jax_descs(shared=True), num_stages=2,
                       loss_fn=lambda o, t: pt.nn.functional.cross_entropy(
                           o, t))
        init = {k: np.asarray(p._data) for k, p in layer.named_parameters()}

        def loss_of(p):
            out, _ = functional_call(layer, p, {}, (Tensor(x),),
                                     training=True)
            return layer._loss_fn(out, Tensor(y.astype(np.int32)))._data

        grads = jax.grad(loss_of)({k: jnp.asarray(a)
                                   for k, a in init.items()})
        norm = float(jnp.sqrt(sum(jnp.sum(g * g) for g in grads.values())))
        model = JParallel(layer)
        model.accumulate_steps = 4
        opt = pt.optimizer.SGD(learning_rate=0.1,
                               parameters=layer.parameters(),
                               grad_clip=pt.nn.ClipGradByGlobalNorm(CLIP))
        losses = [float(model.train_batch((Tensor(x),
                                           Tensor(y.astype(np.int32))), opt))
                  for _ in range(STEPS)]
        assert model._pp_step is not None      # the compiled pipeline ran
        params = {k: np.asarray(v._data)
                  for k, v in model.state_dict().items()}
        return {"x": x, "y": y, "init": init, "losses": losses,
                "norm": norm, "params": params}
    finally:
        jdist.set_mesh(None)
        jdist.destroy_process_group()


def test_train_batch_over_pipeline_layer_matches_jax(tmp_path):
    ref = _jax_blocks()
    assert ref["norm"] > 2 * CLIP                      # the clip bites
    ranks = spawn(_block_rank, args=(ref["init"], ref["x"], ref["y"]),
                  nprocs=2, store=str(tmp_path / "store"),
                  timeout=SPAWN_TIMEOUT)
    full = {}
    for r in ranks:
        assert r["type"] == "PipelineParallel"
        assert "GradScaler" in r["scaler"] and "item 9" in r["scaler"]
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=0,
                                   atol=SLICE_TOL)
        # the shared layer's copy counts once in the global norm
        assert r["shared"] == sorted([TIE, TIE.replace("weight", "bias")])
        assert abs(r["norms"][0] - ref["norm"]) <= NORM_RTOL * ref["norm"]
        assert len(set(r["norms"])) == STEPS
        # the planted fault: both copies counted
        assert abs(r["counted_twice"][0] - ref["norm"]) > \
            NORM_RTOL * ref["norm"], r["counted_twice"]
        full.update(r["params"])
    assert ranks[0]["eval"] == ranks[1]["eval"]
    assert set(full) == set(ref["params"])
    assert set(ranks[0]["params"]) != set(ranks[1]["params"])
    # the shared layer: the same bits on both stages
    np.testing.assert_array_equal(ranks[0]["params"][TIE],
                                  ranks[1]["params"][TIE])
    for name, want in ref["params"].items():
        np.testing.assert_allclose(full[name], want, rtol=0, atol=SLICE_TOL,
                                   err_msg=name)
        moved = want - ref["init"][name]
        assert np.linalg.norm(full[name] - ref["init"][name] - moved) <= \
            UPDATE_RTOL * np.linalg.norm(moved), name
    assert ref["losses"][-1] < ref["losses"][0]


# -- GPT pipelined, alone and composed ------------------------------------------------

MESHES = {
    # name: (dp, mp, pp, sharding, v, micro-batches, level, batch)
    "pp2_v1": (1, 1, 2, 1, 1, 4, None, 8),
    "pp2_v2": (1, 1, 2, 1, 2, 2, None, 8),
    "pp2xsh2_os_g": (1, 1, 2, 2, 1, 2, "os_g", 8),
    "mp2xpp2xsh2_v2": (1, 2, 2, 2, 2, 2, "os_g", 8),
    "dp2xpp2_v2": (2, 1, 2, 1, 2, 2, None, 8),
    "pp2xsh2_p_g_os": (1, 1, 2, 2, 1, 2, "p_g_os", 8),
}


def _gpt_batch(b):
    rng = np.random.RandomState(3)
    return (rng.randint(0, 1024, (b, 32)).astype(np.int64),
            rng.randint(0, 1024, (b, 32)).astype(np.int64))


def _pp_rank(arrays, mesh, planted):
    from paddle_tpu_torch.train import build_train_step
    dp, mp, pp, sh, v, M, level, b = MESHES[mesh]
    tdist.init_parallel_env(device="cpu")
    cfg = dataclasses.replace(gpt_tiny(**NO_DROPOUT), num_layers=LAYERS)

    def build():
        step = build_train_step(cfg, device="cpu", amp_o2=False, dp=dp,
                                mp=mp, pp=pp, sharding=sh,
                                sharding_level=level, microbatches=M,
                                virtual_stages=v, capture=False,
                                optimizer=_optimizer())
        load_arrays(step, arrays)
        return step

    step = build()
    ids, labels = (torch.from_numpy(a) for a in _gpt_batch(b))
    losses, norms, words = [], [], []
    for _ in range(STEPS):
        losses.append(step(ids, labels).item())
        norms.append(step.optimizer._grad_clip.last_norm.item())
        if WORD in step.params:
            words.append(step.params[WORD].detach().numpy().copy())
    out = rank_result(step, losses, norms)
    out["words"] = words
    tree = step.checkpoint_tree()
    out["checkpoint_tree"] = {n: (w.spec, w.window, w.write)
                              for n, w in tree["params"].items()}
    if planted:
        out["planted"] = {}
        # a micro-batch's gradient dropped: the last virtual stage's
        # logits of micro-batch 1 pass no gradient back
        step = build()
        net = step.model
        last, calls = pp * v - 1, [0]
        chunk = net.forward_chunk

        def dropping(k, x, generator=None):
            y = chunk(k, x, generator=generator)
            if k == last:
                calls[0] += 1
                if calls[0] % M == 2:
                    y = y.detach() + (y - y.detach()) * 0
            return y

        net.forward_chunk = dropping
        out["planted"]["dropped"] = rank_result(
            step, *run_steps(step, _gpt_batch(b)))
        # the tied gradient not summed over the two stages
        step = build()
        step.zero.tied = {}
        res = rank_result(step, *run_steps(step, _gpt_batch(b)))
        res["word"] = step.params[WORD].detach().numpy().copy()
        out["planted"]["untied"] = res
    return out


@functools.lru_cache(maxsize=None)
def _jax_pp(mesh):
    """The JAX pipelined step on the mesh (every axis named): initial
    weights, losses, updated weights by block name, the first gradient's
    norm, each moment's shard by device coordinates."""
    import jax
    import jax.numpy as jnp
    import paddle_tpu as pt
    import paddle_tpu.distributed as jdist
    from paddle_tpu.distributed.fleet.meta_parallel.pp_spmd import \
        natural_stack
    from paddle_tpu.distributed.sharding import group_sharded_parallel
    from paddle_tpu.distributed.train_step import build_train_step
    from paddle_tpu.incubate.models import gpt as jgpt
    from paddle_tpu.jit.api import functional_call
    from paddle_tpu.tensor import Tensor
    dp, mp, pp, sh, v, M, level, b = MESHES[mesh]
    try:
        pt.seed(0)
        cfg = jgpt.gpt_tiny(**NO_DROPOUT)
        cfg.num_layers = LAYERS
        model = jgpt.GPTForCausalLM(cfg)
        crit = jgpt.GPTPretrainingCriterion()
        init = {k: np.asarray(p._data) for k, p in model.named_parameters()}
        ids, labels = (a.astype(np.int32) for a in _gpt_batch(b))

        def loss_of(p):
            out, _ = functional_call(model, p, {}, (Tensor(ids),),
                                     training=True)
            return crit(out, Tensor(labels))._data

        grads = jax.grad(loss_of)({k: jnp.asarray(a)
                                   for k, a in init.items()})
        norm = float(jnp.sqrt(sum(jnp.sum(g * g) for g in grads.values())))
        jmesh = jdist.init_mesh({"dp": dp, "mp": mp, "pp": pp,
                                 "sharding": sh, "sep": 1},
                                devices=jax.devices()[:dp * mp * pp * sh])
        opt = pt.optimizer.AdamW(learning_rate=LR,
                                 parameters=model.parameters(),
                                 grad_clip=pt.nn.ClipGradByGlobalNorm(CLIP))
        if level is not None:
            model, opt, _ = group_sharded_parallel(model, opt, level=level)
        step, state = build_train_step(model, lambda lg, lb: crit(lg, lb),
                                       opt, mesh=jmesh,
                                       pipeline_virtual_stages=v)
        losses = []
        for _ in range(STEPS):
            loss, state = step(state, ids, labels)
            losses.append(float(loss))
        params = {}
        for k, a in state["params"].items():
            if k.startswith("__ppstack__."):
                nat = np.asarray(natural_stack(a, LAYERS))
                for i in range(LAYERS):
                    params[f"gpt.layers.{i}.{k[len('__ppstack__.'):]}"] = \
                        nat[i]
            else:
                params[k] = np.asarray(a)
        return {"init": init, "losses": losses, "norm": norm,
                "params": params,
                "shards": device_shards(state["opt"]["slots"], jmesh),
                "stacked": {"pp": pp, "v": v,
                            "per": LAYERS // (pp * v)}}
    finally:
        jdist.set_mesh(None)
        jdist.destroy_process_group()


_RUNS = {}


@pytest.fixture(scope="module")
def pp_runs(tmp_path_factory):
    def get(mesh):
        if mesh not in _RUNS:
            dp, mp, pp, sh = MESHES[mesh][:4]
            n = dp * mp * pp * sh
            root = tmp_path_factory.mktemp(mesh)
            _RUNS[mesh] = spawn(
                _pp_rank, args=(_jax_pp(mesh)["init"], mesh,
                                mesh == "pp2_v1"),
                nprocs=n, store=str(root / "store"),
                timeout=SPAWN_TIMEOUT_8 if n == 8 else SPAWN_TIMEOUT)
        return _RUNS[mesh]
    yield get
    _RUNS.clear()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_pipelined_gpt_matches_the_jax_pipelined_step(pp_runs, mesh):
    ranks = pp_runs(mesh)
    ref = _jax_pp(mesh)
    assert ref["norm"] > 2 * CLIP                      # the clip bites
    err = check_against_jax(ranks, ref, stacked=ref["stacked"])
    assert err["loss"] <= SLICE_TOL, err
    assert err["weight"] <= SLICE_TOL, err
    assert err["update"] <= UPDATE_RTOL, err
    assert err["moment"] <= SLICE_TOL, err
    assert err["moment_rel"] <= MOMENT_RTOL, err
    assert err["norm"] <= NORM_RTOL, err
    assert ref["losses"][-1] < ref["losses"][0]
    stages = {r["coords"][1] for r in ranks}
    assert stages == {0, 1}
    for r in ranks:
        # the sharded checkpoint: each stage's rows of the stacked blocks
        dp, s, sh, mp = r["coords"]
        v = MESHES[mesh][4]
        spec, window, _ = r["checkpoint_tree"][
            "__ppstack__.attn.qkv_proj.weight"]
        per = LAYERS // (2 * v)
        assert spec[:2 if v > 1 else 1] == ([None, "pp"] if v > 1
                                            else ["pp"])
        assert window[v > 1] == [s * per, (s + 1) * per]
        # the tied word embedding, on both stages, written by the first
        wspec, _, write = r["checkpoint_tree"][WORD]
        assert write == (s == 0 and dp == 0 and
                         (sh == 0 or "sharding" in wspec))
    # the tied embedding: the same bits on the first and last stage after
    # every step
    by = {r["coords"]: r for r in ranks}
    for (dp, s, sh, mp), r in by.items():
        if s == 0:
            other = by[(dp, 1, sh, mp)]
            assert len(r["words"]) == len(other["words"]) == STEPS
            for a, b in zip(r["words"], other["words"]):
                np.testing.assert_array_equal(a, b)


def test_planted_dropped_microbatch_gradient_fails(pp_runs):
    ranks = pp_runs("pp2_v1")
    err = check_against_jax([r["planted"]["dropped"] for r in ranks],
                            _jax_pp("pp2_v1"),
                            stacked=_jax_pp("pp2_v1")["stacked"])
    assert err["weight"] > SLICE_TOL and err["update"] > UPDATE_RTOL, err
    assert err["moment_rel"] > MOMENT_RTOL, err


def test_planted_untied_gradient_fails(pp_runs):
    ranks = pp_runs("pp2_v1")
    res = [r["planted"]["untied"] for r in ranks]
    assert not np.array_equal(res[0]["word"], res[1]["word"])
    err = check_against_jax(res, _jax_pp("pp2_v1"),
                            stacked=_jax_pp("pp2_v1")["stacked"])
    assert err["weight"] > SLICE_TOL or err["update"] > UPDATE_RTOL, err


# -- degree 1 and the CLI ----------------------------------------------------------

def _degree_one_rank(batch):
    from paddle_tpu_torch.train import build_train_step
    tdist.init_parallel_env(device="cpu")
    cfg = gpt_tiny()                               # dropout 0.1
    ids, labels = (torch.from_numpy(a) for a in batch)
    plain = build_train_step(cfg, device="cpu", amp_o2=False, fusion=False)
    want = [plain(ids, labels).item() for _ in range(STEPS)]
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                        "sharding_degree": 1}
    s.sharding = True
    s.sharding_configs = {"stage": 2}
    hyb = build_train_step(cfg, device="cpu", amp_o2=False, strategy=s,
                           capture=False)
    from paddle_tpu_torch.distributed.sharding import zero_level
    got = [hyb(ids, labels).item() for _ in range(STEPS)]
    same = all(torch.equal(plain.params[n], p) for n, p in
               hyb.params.items())
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"sep_degree": 2}
    try:
        fleet.init(is_collective=True, strategy=s)
    except ValueError as e:
        sep = str(e)
    return {"want": want, "got": got, "same": same, "sep": sep,
            "level": zero_level(hyb.optimizer),
            "zero": hyb.zero is None}


def test_degree_one_with_os_g_is_the_single_card_step(tmp_path):
    [res] = spawn(_degree_one_rank, args=(_batch(),), nprocs=1,
                  store=str(tmp_path / "store"), timeout=SPAWN_TIMEOUT)
    assert res["level"] == "os_g" and res["zero"]
    assert res["got"] == res["want"]
    assert res["same"]
    # sep is ported: like every degree it must cover the world (a world
    # of one here), and nothing names a ROADMAP item
    assert "'sep_degree': 2" in res["sep"] and \
        "make 2 ranks; the world has 1" in res["sep"]
    assert "item 4.3" not in res["sep"]


def test_train_cli_spawns_pp_x_sharding_ranks(monkeypatch):
    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.train import main
    bounded = distributed.spawn
    monkeypatch.setattr(distributed, "spawn", lambda *a, **kw: bounded(
        *a, timeout=SPAWN_TIMEOUT, **kw))
    assert main(["--model", "gpt_tiny", "--pp", "2", "--sharding", "2",
                 "--batch", "8", "--seq", "32", "--steps", "2",
                 "--microbatches", "2", "--device", "cpu"]) == 0
