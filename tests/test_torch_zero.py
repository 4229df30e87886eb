"""ZeRO in the port (group sharding, stages 1-3), on the CPU over gloo
ranks, held to the JAX package.

 - Pure functions, no spawn: ``place_axis`` / ``zero_spec`` over a grid
   of shapes, specs and sharding degrees; ``plan_grad_reduction`` over
   dp x sharding x level with the kill switch; ``partition_buckets``
   with ``scatter_dims`` and the rank-major packing against the JAX
   ``partition_buckets``, ``_to_rank_major`` and ``_from_rank_major``
   (one reduce-scatter of a packed bucket hands rank ``r`` its
   ``zero_spec`` windows); ``DygraphShardingOptimizer``'s greedy
   partition by name; the gloo transport's host copies.
 - The step, parametrised over level in {os, os_g, p_g_os} at dp 1 x
   sharding 2 (two ranks) and dp 2 x sharding 2 (four ranks; one spawn a
   mesh runs the three levels): ``gpt_tiny`` in f32 with dropout 0,
   three ``AdamW(1e-3)`` steps with a global-norm clip of 0.5 that
   bites, against the JAX ``build_train_step`` after
   ``group_sharded_parallel(level)`` on a mesh naming every axis
   (``__graft_entry__.py:118-119``): losses and the gathered updated
   weights within ``SLICE_TOL``; each tensor's update within
   ``UPDATE_RTOL`` of the JAX update in 2-norm; each rank's moment
   windows within ``SLICE_TOL`` of the JAX state's shard on the device at
   its (dp, sharding) coordinates (``addressable_shards``), and within
   ``MOMENT_RTOL`` of each tensor's largest value there; the clip's
   norm within ``NORM_RTOL`` of the JAX norm; each rank's optimizer-state
   bytes for parameters of at least ``MIN_SIZE`` elements at most
   ``STATE_SHARE`` of the world of one's.
 - ``strategy.sharding`` with ``sharding_configs`` stage 1 and 2 through
   ``fleet``: the levels ``os`` and ``os_g``, the same losses;
   ``save_group_sharded_model``'s files read back; ``checkpoint_tree``'s
   window of a moment.
 - The planted fault, two ranks' windows traded, fails the comparison,
   the moments' too; so does one slot's windows traded after an honest
   run (each slot is held against its own scale, ``MOMENT_RTOL``).
 - A loop of one's own over ``fleet.distributed_model`` in sharding mode
   and over ``group_sharded_parallel(level="p_g_os")`` (both a
   ``ShardingParallel``), held to the JAX step at ``p_g_os``; a ZeRO
   level on the optimizer refuses a tree update that no ``ZeroPlan``
   drives.

Each spawn is bounded by ``SPAWN_TIMEOUT`` seconds and uses a file store
under the test's temporary directory.  The ranks' functions import
neither JAX nor the JAX package.
"""
import functools

import numpy as np
import pytest
import torch

from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.distributed import fleet, spawn
from paddle_tpu_torch.incubate.models import gpt_tiny

SPAWN_TIMEOUT = 60
SLICE_TOL = 2e-4
UPDATE_RTOL = 1e-2
MOMENT_RTOL = 1e-3
NORM_RTOL = 1e-5
STATE_SHARE = 0.55
LR, CLIP, STEPS = 1e-3, 0.5, 3
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
B, S = 4, 32
LEVELS = ("os", "os_g", "p_g_os")
MESHES = {"dp1xsh2": (1, 2), "dp2xsh2": (2, 2)}


def _batch():
    rng = np.random.RandomState(3)
    return (rng.randint(0, 1024, (B, S)).astype(np.int64),
            rng.randint(0, 1024, (B, S)).astype(np.int64))


# -- pure functions -----------------------------------------------------------

SHAPES = [(1024, 3072), (3072,), (7,), (64, 128), (128, 64), (6, 6), (3, 5),
          (4, 96, 96), (12, 8, 2)]
SPECS = [(), ("mp",), (None, "mp"), ("sharding", None), (("dp", "mp"),)]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_place_axis_and_zero_spec_match_jax(n, spec):
    from jax.sharding import PartitionSpec as P
    from paddle_tpu.distributed.auto_parallel.spec_layout import \
        place_axis as jax_place
    from paddle_tpu.distributed.train_step import zero_spec as jax_zero
    from paddle_tpu_torch.distributed.auto_parallel import place_axis
    from paddle_tpu_torch.distributed.sharding import zero_spec

    class Mesh:
        shape = {"sharding": n}

    for shape in SHAPES:
        if len(spec) > len(shape):
            continue
        want = tuple(jax_place(P(*spec), shape, n, "sharding"))
        want = want + (None,) * (len(shape) - len(want))
        assert place_axis(spec, shape, n, "sharding") == want, shape
        z = tuple(jax_zero(P(*spec), shape, Mesh()))
        assert zero_spec(spec, shape, n) == z + (None,) * (len(shape) -
                                                           len(z)), shape


def test_zero_dim_reads_the_global_shape_and_the_mp_axis():
    from paddle_tpu_torch.distributed.sharding import zero_dim
    w = torch.zeros(1024, 1536)          # mp rank's slice of (1024, 3072)
    w.split_axis = 1
    assert zero_dim(w, 2, mp=2) == 0     # dim 1 carries mp
    assert zero_dim(torch.zeros(1024, 3072), 2) == 1
    assert zero_dim(torch.zeros(7, 9), 2) is None
    assert zero_dim(torch.zeros(64), 1) is None


@pytest.mark.parametrize("switch", ["on", "off"])
@pytest.mark.parametrize("level", [None, "os", "os_g"])
@pytest.mark.parametrize("sh", [1, 2, 4])
@pytest.mark.parametrize("dp", [1, 2, 4])
def test_plan_grad_reduction_matches_jax(dp, sh, level, switch,
                                         monkeypatch):
    from paddle_tpu.distributed import collective_schedule as jcs
    from paddle_tpu_torch.distributed import collective_schedule as tcs
    if switch == "off":
        monkeypatch.setenv("PT_COLLECTIVE_SCHEDULE", "0")
    sizes = {"dp": dp, "sharding": sh, "mp": 2}
    want = jcs.plan_grad_reduction(sizes, level)
    got = tcs.plan_grad_reduction(sizes, level)
    if want is None:
        assert got is None
        return
    assert got.describe() == want.describe()
    assert (got.shard_axis, got.shard_size, got.kind, got.scatters) == \
        (want.shard_axis, want.shard_size, want.kind, want.scatters)
    assert [(s.op, s.axis, s.size) for s in got.stages] == \
        [(s.op, s.axis, s.size) for s in want.stages]


def test_scatter_buckets_match_jax_partition_buckets():
    from paddle_tpu.distributed.grad_buckets import \
        partition_buckets as jax_partition
    from paddle_tpu_torch.distributed.grad_buckets import partition_buckets
    shapes = {"w1": (64, 128), "w2": (128, 64), "b": (128,), "odd": (7, 9),
              "e": (256, 256), "g": (30,)}
    dims = {"w1": 1, "w2": 0, "b": 0, "e": 0, "g": 0}
    arrays = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    tensors = {k: torch.zeros(s) for k, s in shapes.items()}
    for target in (1, 4096, 40_000, 1 << 20):
        want = jax_partition(arrays, target, scatter_dims=dims)
        got = partition_buckets(tensors, target, scatter_dims=dims)
        assert [(b.names, b.sizes, b.nbytes, b.kind, b.dims)
                for b in got.buckets] == \
            [(b.names, b.sizes, b.nbytes, b.kind, b.dims)
             for b in want.buckets], target
    kinds = {n: b.kind for b in partition_buckets(
        tensors, 1 << 20, scatter_dims=dims).buckets for n in b.names}
    assert kinds["odd"] == "all_reduce" and kinds["w1"] == "reduce_scatter"


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("shape,dim", [((8, 6), 0), ((8, 12), 1),
                                       ((4, 8, 12), 1), ((4, 8, 12), 2),
                                       ((16,), 0)])
def test_rank_major_packing_matches_jax(shape, dim, n):
    import jax.numpy as jnp
    from paddle_tpu.distributed.grad_buckets import (_from_rank_major,
                                                     _to_rank_major)
    from paddle_tpu_torch.distributed.grad_buckets import (from_rank_major,
                                                           to_rank_major)
    from paddle_tpu_torch.distributed.sharding.group_sharded import window
    arr = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    want = np.asarray(_to_rank_major(jnp.asarray(arr), dim, n))
    got = to_rank_major(torch.from_numpy(arr), dim, n).numpy()
    np.testing.assert_array_equal(got, want)
    for r in range(n):         # row r is rank r's window, raveled
        np.testing.assert_array_equal(
            got[r], window(torch.from_numpy(arr), dim, n, r).reshape(-1))
    np.testing.assert_array_equal(
        from_rank_major(torch.from_numpy(got), shape, dim, n).numpy(),
        np.asarray(_from_rank_major(jnp.asarray(want), shape, dim, n)))
    # a bucket of two members packed side by side, reduced over 3
    # "ranks" and scattered: rank r's row is the sum of their windows r
    other = np.ones((4, 2 * n), np.float32)
    block = [torch.cat([to_rank_major(torch.from_numpy(arr * (i + 1)), dim,
                                      n),
                        to_rank_major(torch.from_numpy(other), 1, n)], 1)
             for i in range(3)]
    total = sum(block)
    w = arr.size // n
    for r in range(n):
        np.testing.assert_array_equal(total[r, :w].reshape(-1),
                                      (6 * window(torch.from_numpy(arr), dim,
                                                  n, r)).reshape(-1))


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_sharding_optimizer_partition_matches_jax(n, jax_dist):
    import paddle_tpu as pt
    from paddle_tpu.distributed.fleet.meta_optimizers import \
        dygraph_sharding_optimizer as jdso
    from paddle_tpu.incubate.models import gpt as jgpt
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        DygraphShardingOptimizer
    from paddle_tpu_torch.framework.random import make_generator
    from paddle_tpu_torch.incubate.models import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.distributed.sharding import zero_level

    class Hcg:
        def get_sharding_parallel_world_size(self):
            return n

    pt.seed(0)
    jmodel = jgpt.GPTForCausalLM(jgpt.gpt_tiny())
    jnames = {id(p): k for k, p in jmodel.named_parameters()}
    jopt = pt.optimizer.AdamW(parameters=[p for _, p in
                                          jmodel.named_parameters()])
    want = jdso.DygraphShardingOptimizer(jopt, hcg=Hcg())._rank2params
    tmodel = GPTForCausalLM(gpt_tiny(), generator=make_generator(0, "cpu"))
    tnames = {id(p): k for k, p in tmodel.named_parameters()}
    topt = AdamW(parameters=[p for _, p in tmodel.named_parameters()])
    got = DygraphShardingOptimizer(topt, hcg=Hcg())
    assert {r: [tnames[id(p)] for p in ps]
            for r, ps in got._rank2params.items()} == \
        {r: [jnames[id(p)] for p in ps] for r, ps in want.items()}
    assert zero_level(got) == zero_level(topt) == "os"


@pytest.fixture
def jax_dist():
    import paddle_tpu.distributed as jdist
    yield jdist
    jdist.set_mesh(None)
    jdist.destroy_process_group()


# -- gloo's host copies --------------------------------------------------------

def _staged_rank(data):
    from paddle_tpu_torch.distributed import collective
    tdist.init_parallel_env(device="cpu")
    me = tdist.get_rank()
    plain = tdist.reduce_scatter(torch.from_numpy(data[me]))
    # every CUDA tensor on gloo goes through the host: pin the route with
    # CPU tensors taken for card tensors
    staged = []
    collective.host_staged = lambda group, t: staged.append(1) or True
    through_host = tdist.reduce_scatter(torch.from_numpy(data[me]))
    x = torch.zeros(3)
    peer = 1 - me
    for task in tdist.batch_isend_irecv([
            tdist.P2POp(tdist.isend, torch.full((3,), float(me + 1)), peer),
            tdist.P2POp(tdist.irecv, x, peer)]):
        task.wait()
    return {"plain": plain.numpy(), "staged": through_host.numpy(),
            "p2p": x.numpy(), "n_staged": len(staged)}


def test_gloo_routes_point_to_point_and_reduce_scatter_through_host(
        tmp_path):
    from paddle_tpu_torch.distributed import collective

    class Cuda:
        is_cuda = True

    group = tdist.Group(0, [0, 1], 1, None)
    group.__class__ = type("G", (tdist.Group,), {"backend": "gloo"})
    assert collective.host_staged(group, Cuda())
    assert not collective.host_staged(group, torch.zeros(1))
    group.__class__ = type("N", (tdist.Group,), {"backend": "nccl"})
    assert not collective.host_staged(group, Cuda())
    data = np.arange(2 * 4, dtype=np.float32).reshape(2, 4)
    a, b = spawn(_staged_rank, args=(data,), nprocs=2,
                 store=str(tmp_path / "store"), timeout=SPAWN_TIMEOUT)
    for r, res in enumerate((a, b)):
        want = data.sum(0)[2 * r:2 * r + 2]
        np.testing.assert_array_equal(res["plain"], want)
        np.testing.assert_array_equal(res["staged"], want)
        np.testing.assert_array_equal(res["p2p"], np.full(3, 2.0 - r))
        assert res["n_staged"] >= 3


# -- the step against the JAX package -------------------------------------------

def load_arrays(step, arrays):
    """The JAX model's arrays into a hybrid step's parameters: each
    rank's mp slice, and the window of a stored window."""
    from paddle_tpu_torch.distributed.sharding import is_window
    hcg = fleet.get_hybrid_communicate_group()
    m, n_mp = hcg.get_model_parallel_rank(), \
        hcg.get_model_parallel_world_size()
    r, n = hcg.get_sharding_parallel_rank(), \
        hcg.get_sharding_parallel_world_size()
    with torch.no_grad():
        for name, p in step.params.items():
            a = np.asarray(arrays[name])
            axis = getattr(p, "split_axis", None)
            if axis is not None:
                a = np.split(a, n_mp, axis)[m]
            if is_window(p):
                a = np.split(a, n, p.zero_dim)[r]
            p.copy_(torch.from_numpy(np.ascontiguousarray(a)))


def rank_result(step, losses, norms):
    """What the tests read from a rank: coordinates, losses, norms, the
    whole parameters (stage-3 windows gathered), the moment slots."""
    from paddle_tpu_torch.distributed.sharding import full_parameters
    hcg = step.hcg
    return {"coords": (hcg.get_data_parallel_rank(), hcg.get_stage_id(),
                       hcg.get_sharding_parallel_rank(),
                       hcg.get_model_parallel_rank()),
            "losses": losses, "norms": norms,
            "params": {n: t.numpy().copy()
                       for n, t in full_parameters(step.model).items()},
            "axes": {n: getattr(p, "split_axis", None)
                     for n, p in step.params.items()},
            "slots": {s: {n: t.numpy().copy() for n, t in tree.items()}
                      for s, tree in step.state["slots"].items()}}


def run_steps(step, batch, n=STEPS):
    ids, labels = (torch.from_numpy(a) for a in batch)
    losses, norms = [], []
    for _ in range(n):
        losses.append(step(ids, labels).item())
        norms.append(step.optimizer._grad_clip.last_norm.item())
    return losses, norms


def _optimizer():
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    return AdamW(learning_rate=LR, grad_clip=ClipGradByGlobalNorm(CLIP))


def _zero_rank(arrays, batch, dp, sh, out_dir):
    from paddle_tpu_torch.distributed.sharding import (
        MIN_SIZE, save_group_sharded_model, state_bytes, window)
    from paddle_tpu_torch.train import build_train_step
    tdist.init_parallel_env(device="cpu")
    cfg = gpt_tiny(**NO_DROPOUT)
    res = {}
    for level in LEVELS:
        step = build_train_step(cfg, device="cpu", amp_o2=False, dp=dp,
                                sharding=sh, sharding_level=level,
                                capture=False, optimizer=_optimizer())
        load_arrays(step, arrays)
        out = rank_result(step, *run_steps(step, batch))
        big = [n for n, a in arrays.items() if np.asarray(a).size >= MIN_SIZE]
        whole = sum(np.asarray(arrays[n]).size * 4 * 2 for n in big)
        out["state_share"] = state_bytes(step.state, big) / whole
        out["level"] = step.zero.level
        if level == "p_g_os":
            save_group_sharded_model(step.model, out_dir, step.optimizer)
        w = step.checkpoint_tree()["opt_tree"]["slots"]["moment1"][
            "gpt.layers.0.attn.qkv_proj.weight"]
        out["checkpoint_tree"] = (w.spec, w.window, w.write)
        res[level] = out
    if dp == 1:
        # fleet's strategy: sharding_configs stage 1 and 2
        for stage in (1, 2):
            s = fleet.DistributedStrategy()
            s.hybrid_configs = {"sharding_degree": sh}
            s.sharding = True
            s.sharding_configs = {"stage": stage}
            step = build_train_step(cfg, device="cpu", amp_o2=False,
                                    strategy=s, capture=False,
                                    optimizer=_optimizer())
            load_arrays(step, arrays)
            res[f"stage{stage}"] = {"level": step.zero.level,
                                    "losses": run_steps(step, batch)[0]}
        # the planted fault: the two ranks' windows traded
        step = build_train_step(cfg, device="cpu", amp_o2=False,
                                sharding=sh, sharding_level="os_g",
                                capture=False, optimizer=_optimizer())
        load_arrays(step, arrays)
        z = step.zero
        z.views = {k: (window(p.data, z.dims[k], z.n, z.n - 1 - z.rank)
                       if k in z.dims else p) for k, p in z.params.items()}
        res["planted"] = rank_result(step, *run_steps(step, batch))
    return res


@functools.lru_cache(maxsize=None)
def _jax_zero(level, dp, sh):
    """The JAX step after group_sharded_parallel(level) on a dp x sharding
    mesh: initial weights, losses, updated weights, the first gradient's
    norm, and each moment's shard by device coordinates."""
    import jax
    import jax.numpy as jnp
    import paddle_tpu as pt
    import paddle_tpu.distributed as jdist
    from paddle_tpu.distributed.sharding import group_sharded_parallel
    from paddle_tpu.distributed.train_step import build_train_step
    from paddle_tpu.incubate.models import gpt as jgpt
    from paddle_tpu.jit.api import functional_call
    from paddle_tpu.tensor import Tensor
    try:
        pt.seed(0)
        model = jgpt.GPTForCausalLM(jgpt.gpt_tiny(**NO_DROPOUT))
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
        mesh = jdist.init_mesh({"dp": dp, "pp": 1, "sharding": sh, "sep": 1,
                                "mp": 1}, devices=jax.devices()[:dp * sh])
        opt = pt.optimizer.AdamW(learning_rate=LR,
                                 parameters=model.parameters(),
                                 grad_clip=pt.nn.ClipGradByGlobalNorm(CLIP))
        model, opt, _ = group_sharded_parallel(model, opt, level=level)
        step, state = build_train_step(model, lambda lg, lb: crit(lg, lb),
                                       opt, mesh=mesh)
        losses = []
        for _ in range(STEPS):
            loss, state = step(state, ids, labels)
            losses.append(float(loss))
        return {"init": init, "losses": losses, "norm": norm,
                "params": {k: np.asarray(v)
                           for k, v in state["params"].items()},
                "shards": device_shards(state["opt"]["slots"], mesh)}
    finally:
        jdist.set_mesh(None)
        jdist.destroy_process_group()


def device_shards(slots, mesh):
    """{slot: {name: [(coords, data)]}}: each device's shard, by its mesh
    coordinates ({axis: index})."""
    out = {}
    for s, tree in slots.items():
        out[s] = {}
        for name, arr in tree.items():
            rows = []
            for shard in arr.addressable_shards:
                pos = np.argwhere(mesh.devices == shard.device)[0]
                coords = dict(zip(mesh.axis_names, map(int, pos)))
                coords["start"] = tuple(sl.start or 0 for sl in shard.index)
                rows.append((coords, np.asarray(shard.data)))
            out[s][name] = rows
    return out


def by_coords(ranks):
    return {r["coords"]: r for r in ranks}


def check_against_jax(ranks, ref, stacked=None):
    """The comparisons of the module docstring; returns the largest
    errors ({what: value}) and raises nothing, so a planted fault can be
    measured against the same bounds."""
    err = {"loss": 0.0, "weight": 0.0, "update": 0.0, "moment": 0.0,
           "moment_rel": 0.0, "norm": 0.0}
    for r in ranks:
        err["loss"] = max(err["loss"], max(abs(a - b) for a, b in zip(
            r["losses"], ref["losses"])))
        err["norm"] = max(err["norm"], abs(r["norms"][0] - ref["norm"]) /
                          ref["norm"])
    full = gathered(ranks)
    for name, want in ref["params"].items():
        got = full[name]
        err["weight"] = max(err["weight"], float(np.abs(got - want).max()))
        moved = want - ref["init"][name]
        err["update"] = max(err["update"], float(
            np.linalg.norm(got - ref["init"][name] - moved) /
            np.linalg.norm(moved)))
    at = by_coords(ranks)
    covered = set()
    diffs, scale = {}, {}        # (slot, name) -> max |got - want|, |want|
    for s, tree in ref["shards"].items():
        for name, rows in tree.items():
            for coords, data in rows:
                key = (coords.get("dp", 0), coords.get("pp", 0),
                       coords.get("sharding", 0), coords.get("mp", 0))
                for local, want in unstack(name, data, coords, stacked):
                    # a pipeline stage holds only its part of the model
                    # (the JAX devices hold the rest replicated over pp)
                    if local not in at[key]["slots"][s]:
                        continue
                    covered.add((s, local))
                    got = at[key]["slots"][s][local]
                    d = np.inf if got.shape != want.shape else \
                        float(np.abs(got - want).max())
                    diffs[s, local] = max(diffs.get((s, local), 0.0), d)
                    scale[s, local] = max(scale.get((s, local), 0.0),
                                          float(np.abs(want).max()))
    for k, d in diffs.items():
        err["moment"] = max(err["moment"], d)
        # each tensor's slot against its own scale: a second moment is
        # ~(1 - beta2) g^2, far below the absolute bound
        err["moment_rel"] = max(err["moment_rel"],
                                d / scale[k] if scale[k] else
                                (0.0 if d == 0 else np.inf))
    held = {(s, n) for r in ranks for s, tree in r["slots"].items()
            for n in tree}
    if not covered or covered != held:
        err["moment"] = err["moment_rel"] = np.inf
    return err


def unstack(name, data, coords, stacked):
    """A JAX state shard as (port name, array) pairs: itself, or one
    block a row of a pipelined ``__ppstack__`` leaf."""
    if stacked is None or not name.startswith("__ppstack__."):
        return [(name, data)]
    local = name[len("__ppstack__."):]
    pp, per = stacked["pp"], stacked["per"]
    start = coords["start"]
    if stacked["v"] == 1:                  # [n_blocks, ...], rows over pp
        return [(f"gpt.layers.{start[0] + j}.{local}", data[j])
                for j in range(data.shape[0])]
    # [v, pp * Lv, ...]: the groups this shard holds (all, or its window
    # of them), and its stage's rows of each
    return [(f"gpt.layers.{(start[0] + g) * pp * per + start[1] + j}."
             f"{local}", data[g, j])
            for g in range(data.shape[0]) for j in range(data.shape[1])]


def gathered(ranks):
    """The whole weights from the ranks: each name's mp slices
    concatenated (data rank 0)."""
    out = {}
    first = {}
    for r in ranks:
        dp, _, sh, mp = r["coords"]
        if dp or sh:
            continue
        for name, a in r["params"].items():
            first.setdefault(name, {})[mp] = (a, r["axes"][name])
    for name, parts in first.items():
        axis = parts[0][1]
        out[name] = parts[0][0] if axis is None else np.concatenate(
            [parts[m][0] for m in sorted(parts)], axis)
    return out


_RUNS = {}


@pytest.fixture(scope="module")
def zero_runs(tmp_path_factory):
    """One spawn a mesh (run when first asked for): {mesh: (ranks,
    root)}."""
    def get(mesh):
        if mesh not in _RUNS:
            dp, sh = MESHES[mesh]
            root = tmp_path_factory.mktemp(mesh)
            _RUNS[mesh] = (spawn(
                _zero_rank, args=(_jax_zero("os", dp, sh)["init"], _batch(),
                                  dp, sh, str(root / "saved")),
                nprocs=dp * sh, store=str(root / "store"),
                timeout=SPAWN_TIMEOUT), root)
        return _RUNS[mesh]
    yield get
    _RUNS.clear()


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_zero_step_matches_the_jax_group_sharded_step(zero_runs, mesh,
                                                      level):
    ranks, _ = zero_runs(mesh)
    dp, sh = MESHES[mesh]
    ref = _jax_zero(level, dp, sh)
    assert ref["norm"] > 2 * CLIP                      # the clip bites
    res = [r[level] for r in ranks]
    assert all(r["level"] == level for r in res)
    err = check_against_jax(res, ref)
    assert err["loss"] <= SLICE_TOL, err
    assert err["weight"] <= SLICE_TOL, err
    assert err["update"] <= UPDATE_RTOL, err
    assert err["moment"] <= SLICE_TOL, err
    assert err["moment_rel"] <= MOMENT_RTOL, err
    assert err["norm"] <= NORM_RTOL, err
    assert ref["losses"][-1] < ref["losses"][0]
    for r in res:
        assert len(set(r["norms"])) == STEPS          # a norm each step
        assert r["state_share"] <= STATE_SHARE, r["state_share"]
        # the sharded checkpoint's window of the moment: this rank's,
        # written by data rank 0
        spec, window, write = r["checkpoint_tree"]
        assert write == (r["coords"][0] == 0) and "sharding" in spec
        d = spec.index("sharding")
        assert window[d][1] - window[d][0] == \
            r["slots"]["moment1"]["gpt.layers.0.attn.qkv_proj.weight"
                                  ].shape[d]
    # the sharding ranks hold different windows of the same tensor
    w = "gpt.layers.0.attn.qkv_proj.weight"
    at = by_coords(res)
    a, b = at[(0, 0, 0, 0)]["slots"]["moment1"][w], \
        at[(0, 0, 1, 0)]["slots"]["moment1"][w]
    # (128, 384): on its largest dimension, or at p_g_os off the one its
    # layer's mp annotation holds (the JAX fsdp placement)
    assert a.shape == b.shape == ((64, 384) if level == "p_g_os"
                                  else (128, 192))
    assert not np.array_equal(a, b)


def test_zero_planted_traded_windows_fail_the_comparison(zero_runs):
    ranks, _ = zero_runs("dp1xsh2")
    err = check_against_jax([r["planted"] for r in ranks],
                            _jax_zero("os_g", *MESHES["dp1xsh2"]))
    assert err["weight"] > SLICE_TOL and err["update"] > UPDATE_RTOL, err
    assert err["moment_rel"] > MOMENT_RTOL, err


@pytest.mark.parametrize("slot", ["moment1", "moment2"])
def test_swapped_moment_windows_fail_the_comparison(zero_runs, slot):
    """The honest os_g run with one slot's windows traded between the two
    sharding ranks: the moment check must see it, the second moment's
    small values included."""
    ranks, _ = zero_runs("dp1xsh2")
    res = [dict(r["os_g"], slots=dict(r["os_g"]["slots"])) for r in ranks]
    ref = _jax_zero("os_g", *MESHES["dp1xsh2"])
    assert check_against_jax(res, ref)["moment_rel"] <= MOMENT_RTOL
    a, b = res
    a["slots"][slot], b["slots"][slot] = b["slots"][slot], a["slots"][slot]
    err = check_against_jax(res, ref)
    assert err["moment_rel"] > MOMENT_RTOL, err


def test_fleet_strategy_sharding_stages_set_the_levels(zero_runs):
    ranks, _ = zero_runs("dp1xsh2")
    for r in ranks:
        assert r["stage1"]["level"] == "os"
        assert r["stage2"]["level"] == "os_g"
        assert r["stage1"]["losses"] == r["os"]["losses"]
        assert r["stage2"]["losses"] == r["os_g"]["losses"]


# -- an eager loop over fleet's sharding mode and group_sharded_parallel -------------

def _eager_rank(arrays, batch, dp, sh):
    """Three steps of a loop of one's own, at dp x sharding: the model
    through ``fleet.distributed_model`` in sharding mode and through
    ``group_sharded_parallel(level="p_g_os")``, each rank on its rows of
    the batch, then the optimizer's tree update of the wrapped model's
    parameters."""
    import types
    from paddle_tpu_torch.distributed.sharding import (
        group_sharded_parallel, local_batch, mean_over_data_ranks,
        set_zero_level)
    from paddle_tpu_torch.framework.random import make_generator
    from paddle_tpu_torch.incubate.models import (GPTForCausalLM,
                                                  GPTPretrainingCriterion)
    tdist.init_parallel_env(device="cpu")
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "sharding_degree": sh}
    fleet.init(is_collective=True, strategy=s)
    hcg = fleet.get_hybrid_communicate_group()
    ids, labels = local_batch(tuple(torch.from_numpy(a) for a in batch), hcg)
    res = {}
    for entry in ("fleet", "group_sharded"):
        model = GPTForCausalLM(gpt_tiny(**NO_DROPOUT),
                               generator=make_generator(0, "cpu"))
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(torch.from_numpy(np.asarray(arrays[n])))
        if entry == "fleet":
            net = fleet.distributed_model(model)
            opt = fleet.distributed_optimizer(_optimizer())
        else:
            net, opt, _ = group_sharded_parallel(model, _optimizer(),
                                                 level="p_g_os")
        crit = GPTPretrainingCriterion(mp_group=model.mp_group)
        params = dict(net.named_parameters())
        state = opt.init_state_tree(params)
        losses, norms = [], []
        for _ in range(STEPS):
            loss = crit(net(ids), labels)
            loss.backward()
            opt.apply_gradients_tree(
                params, {n: p.grad for n, p in params.items()}, state)
            for p in params.values():
                p.grad = None
            losses.append(mean_over_data_ranks(loss, hcg).item())
            norms.append(opt._grad_clip.last_norm.item())
        step = types.SimpleNamespace(hcg=hcg, model=net, params=params,
                                     state=state)
        res[entry] = rank_result(step, losses, norms)
        res[entry]["type"] = type(net).__name__
    # a ZeRO level on the optimizer and a tree update of whole parameters
    opt = fleet.distributed_optimizer(_optimizer())
    set_zero_level(opt, "os_g")
    try:
        opt.apply_gradients_tree(
            params, {n: torch.zeros_like(p) for n, p in params.items()},
            opt.init_state_tree(params))
    except NotImplementedError as e:
        res["refused"] = str(e)
    return res


@pytest.mark.parametrize("mesh", list(MESHES))
def test_eager_loop_over_sharding_parallel_matches_jax(tmp_path, mesh):
    """fleet's sharding mode and group_sharded_parallel at p_g_os in a
    loop of one's own (the large parameters stored as windows, the other
    gradients averaged over the data ranks after each backward pass),
    held to the JAX step at p_g_os as the ZeroPlan steps are."""
    dp, sh = MESHES[mesh]
    ref = _jax_zero("p_g_os", dp, sh)
    ranks = spawn(_eager_rank, args=(ref["init"], _batch(), dp, sh),
                  nprocs=dp * sh, store=str(tmp_path / "store"),
                  timeout=SPAWN_TIMEOUT)
    for entry in ("fleet", "group_sharded"):
        res = [r[entry] for r in ranks]
        assert all(r["type"] == "ShardingParallel" for r in res)
        err = check_against_jax(res, ref)
        assert err["loss"] <= SLICE_TOL, (entry, err)
        assert err["weight"] <= SLICE_TOL, (entry, err)
        assert err["update"] <= UPDATE_RTOL, (entry, err)
        assert err["moment"] <= SLICE_TOL, (entry, err)
        assert err["moment_rel"] <= MOMENT_RTOL, (entry, err)
        assert err["norm"] <= NORM_RTOL, (entry, err)
    for r in ranks:
        assert "ZeRO level os_g" in r["refused"]
        assert "ZeroPlan" in r["refused"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_save_group_sharded_model_files_read_back(zero_runs, mesh):
    from paddle_tpu_torch.framework.io_state import load
    ranks, root = zero_runs(mesh)
    saved = load(str(root / "saved" / "model.pdparams"))
    want = ranks[0]["p_g_os"]["params"]
    assert set(saved) == set(want)
    for name, a in want.items():
        np.testing.assert_array_equal(saved[name].numpy(), a, err_msg=name)
    assert load(str(root / "saved" / "model.pdopt"))["global_step"] == 0
