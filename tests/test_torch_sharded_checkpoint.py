"""Sharded checkpoints of every hybrid step in the port, held to the
JAX package's layout, on the CPU over gloo ranks (``gpt_tiny`` with
``LAYERS`` blocks, f32).

 - Resume: at mp 2, sharding 2 at ``os``, ``os_g`` and ``p_g_os``, pp 2
   at v 1 and 2, mp 2 x pp 2 (v 2) x sharding 2 and mp 2 x sharding 2 x
   sep 2, dropout 0.1: one step, a save (synchronous, and through an
   asynchronous manager), a fresh step from another seed restored, two
   more steps: the losses, every state tensor and every generator the
   uninterrupted run's bits.
 - Across layouts: the world of one, dp 2 x mp 2, pp 2 at v 1 and mp 2 x
   pp 2 (v 2) x sharding 2 each save after one step (dropout 0) and load
   every other one's checkpoint: the same global bits, the stacked
   ``__ppstack__`` leaves and the per-block ones translated both ways.
 - Into the JAX package: the port's mp 2 x pp 2 x sharding 2 files load
   through the JAX ``load_sharded`` on the 8 CPU devices of
   ``tests/conftest.py`` at the same mesh (a JAX template from the same
   weights) and onto the world of one (``_translate_pp``): the same
   bits.  From it: the JAX step's files at that mesh load into the
   port's ranks at the same layout and at pp 2 (v 1) and the world of
   one with the same bits, and the port steps on from them as the JAX
   step does, within ``check_against_jax``'s bounds.
 - Both packages write the same index at that mesh (the JAX state as
   ``build_train_step`` placed it): leaves, shapes, dtypes and specs;
   the windows' volumes sum to each leaf's size.
 - The manager: one rank's corrupt shard sends every rank back to the
   same earlier step; a second manager on that root, and a second save
   to one path through ``fleet``, keep to their own store keys.  A load
   at a mesh reads and verifies only the shard files its windows meet.
 - Planted faults, each failing: a window written twice (the replica-0
   rule off), two ranks' windows swapped, blocks numbered from a stage's
   template.

The ranks' functions import neither JAX nor the JAX package.
"""
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.distributed import CheckpointManager, spawn
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.incubate.models import gpt_tiny

from test_torch_zero import (MOMENT_RTOL, NORM_RTOL, SLICE_TOL, UPDATE_RTOL,
                             check_against_jax, device_shards, load_arrays,
                             rank_result)

SPAWN_TIMEOUT = 300
LAYERS, B, S, M = 4, 8, 32, 2
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
# name: (dp, mp, pp, sharding, level, virtual stages, sep)
LAYOUTS = {
    "mp2": (1, 2, 1, 1, None, 1, 1),
    "sh2_os": (1, 1, 1, 2, "os", 1, 1),
    "sh2_os_g": (1, 1, 1, 2, "os_g", 1, 1),
    "sh2_p_g_os": (1, 1, 1, 2, "p_g_os", 1, 1),
    "pp2_v1": (1, 1, 2, 1, None, 1, 1),
    "pp2_v2": (1, 1, 2, 1, None, 2, 1),
    "dp2xmp2": (2, 2, 1, 1, None, 1, 1),
    "mp2xpp2xsh2": (1, 2, 2, 2, "os_g", 2, 1),
    "mp2xsh2xsep2": (1, 2, 1, 2, "os_g", 1, 2),
}
RESUME = ["mp2", "sh2_os", "sh2_os_g", "sh2_p_g_os", "pp2_v1", "pp2_v2",
          "mp2xpp2xsh2", "mp2xsh2xsep2"]
CROSS = ["w1", "dp2xmp2", "pp2_v1", "mp2xpp2xsh2"]
BIG = "mp2xpp2xsh2"


def _world(name):
    dp, mp, pp, sh, _, _, sep = LAYOUTS[name]
    return dp * mp * pp * sh * sep


def _cfg(dropout=True):
    cfg = gpt_tiny(**({} if dropout else NO_DROPOUT))
    return dataclasses.replace(cfg, num_layers=LAYERS)


def _batch():
    rng = np.random.RandomState(5)
    return (torch.from_numpy(rng.randint(0, 1024, (B, S)).astype(np.int64)),
            torch.from_numpy(rng.randint(0, 1024, (B, S)).astype(np.int64)))


def _build(name, seed=0, dropout=True, arrays=None):
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.train import build_train_step
    opt = AdamW(learning_rate=1e-3, grad_clip=ClipGradByGlobalNorm(0.5))
    if name == "w1":
        step = build_train_step(_cfg(dropout), device="cpu", amp_o2=False,
                                seed=seed, capture=False, fusion=False,
                                optimizer=opt)
        if arrays is not None:
            from paddle_tpu_torch.incubate.models.gpt import params_from_numpy
            params_from_numpy(step.model, arrays)
        return step
    dp, mp, pp, sh, level, v, sep = LAYOUTS[name]
    step = build_train_step(_cfg(dropout), device="cpu", amp_o2=False,
                            seed=seed, dp=dp, mp=mp, pp=pp, sharding=sh,
                            sharding_level=level, virtual_stages=v,
                            microbatches=M, sep=sep, capture=False,
                            optimizer=opt)
    if arrays is not None:
        load_arrays(step, arrays)
    return step


def windows(step):
    """Every window of ``step``'s params and optimizer state, replicas
    included: [(leaf path, window, global shape, array)]."""
    out = []
    tree = step.checkpoint_tree()
    for path, w in ckpt._flat_items({"params": tree["params"],
                                     "opt_tree": tree["opt_tree"]}):
        if isinstance(w, ckpt.ShardWindow):
            out.append((path, w.window, w.global_shape,
                        w.tensor().numpy().copy()))
        else:
            out.append((path, [[0, d] for d in w.shape], tuple(w.shape),
                        w.detach().numpy().copy()))
    return out


def assemble(rank_windows):
    """The global arrays of every leaf from the ranks' windows; windows
    held by several ranks must agree."""
    out, seen = {}, {}
    for wins in rank_windows:
        for path, win, shape, a in wins:
            g = out.setdefault(path, np.full(shape, np.nan, a.dtype)
                               if a.dtype.kind == "f" else
                               np.zeros(shape, a.dtype))
            sel = tuple(slice(lo, hi) for lo, hi in win)
            key = (path, tuple(map(tuple, win)))
            if key in seen:
                np.testing.assert_array_equal(seen[key], a, err_msg=str(key))
            seen[key] = a
            g[sel] = a
    for path, g in out.items():
        assert not (g.dtype.kind == "f" and np.isnan(g).any()), path
    return out


def natural(leaves, v):
    """``__ppstack__`` leaves as one leaf a block (``gpt.layers.<i>.``)."""
    out = {}
    for path, a in leaves.items():
        name = path[-1]
        if not name.startswith("__ppstack__."):
            out[path] = a
            continue
        rows = a.reshape((-1,) + a.shape[2 if v > 1 else 1:])
        for i, row in enumerate(rows):
            out[path[:-1] + (f"gpt.layers.{i}.{name[12:]}",)] = row
    return out


def _same(a, b):
    assert set(a) == set(b), sorted(set(a) ^ set(b))[:8]
    bad = [k for k in a if a[k].shape != b[k].shape or
           not np.array_equal(a[k], b[k])]
    return bad


# -- the ranks --------------------------------------------------------------------

def _generators(step):
    from paddle_tpu_torch.distributed.checkpoint_layout import generators_of
    return [g.get_state() for g in generators_of(step)]


def _resume(name, root):
    """The uninterrupted run against one save + restore, sync and async:
    {"sync": ok, "async": ok, "losses": ...}."""
    from paddle_tpu_torch.train import restore_checkpoint, save_checkpoint
    ids, labels = _batch()
    a = _build(name)
    full = [a(ids, labels).item() for _ in range(3)]
    b = _build(name)
    first = b(ids, labels).item()
    save_checkpoint(CheckpointManager(os.path.join(root, "sync")), 1, b,
                    block=True)
    amgr = CheckpointManager(os.path.join(root, "async"), async_save=True)
    save_checkpoint(amgr, 1, b)
    amgr.wait()
    out = {"full": full}
    for mode in ("sync", "async"):
        c = _build(name, seed=1)
        n = restore_checkpoint(CheckpointManager(os.path.join(root, mode)),
                               c)
        losses = [first] + [c(ids, labels).item() for _ in range(2)]
        tensors = [np.array_equal(x, y) for (_, _, _, x), (_, _, _, y) in
                   zip(windows(a), windows(c))]
        gens = [torch.equal(x, y) for x, y in
                zip(_generators(a), _generators(c))]
        out[mode] = {"n": n, "losses": losses, "tensors": all(tensors),
                     "n_tensors": len(tensors), "generators": all(gens),
                     "n_generators": len(gens)}
    return out


def _cross(name, root, arrays, load_from):
    """Save this layout after one step (dropout 0) under
    ``root/<name>``; load each of ``load_from``'s checkpoints into a fresh
    step: {"saved": windows, "loaded": {other: windows}}."""
    from paddle_tpu_torch.train import restore_checkpoint, save_checkpoint
    ids, labels = _batch()
    step = _build(name, dropout=False, arrays=arrays)
    step(ids, labels)
    save_checkpoint(CheckpointManager(os.path.join(root, name)), 1, step,
                    block=True)
    out = {"saved": windows(step), "loaded": {}}
    for other in load_from:
        fresh = _build(name, seed=1, dropout=False)
        n = restore_checkpoint(CheckpointManager(os.path.join(root, other)),
                               fresh)
        assert n == 1, (other, n)
        out["loaded"][other] = windows(fresh)
    return out


def _faults(root):
    """At sharding 2 (os_g): the replica-0 rule off (every rank writes
    every window) and, at mp 2, the two ranks' windows swapped."""
    from paddle_tpu_torch.distributed import checkpoint_layout
    ids, labels = _batch()
    out = {}
    step = _build("sh2_os_g", dropout=False)
    step(ids, labels)
    write = checkpoint_layout._Layout.write
    checkpoint_layout._Layout.write = lambda self, spec, name=None: True
    try:
        ckpt.save_sharded(step.checkpoint_tree(),
                          os.path.join(root, "twice"),
                          store=ckpt.ProcessGroupStore.default())
    finally:
        checkpoint_layout._Layout.write = write
    step = _build("mp2", dropout=False)
    step(ids, labels)
    tree = step.checkpoint_tree()
    for _, w in ckpt._flat_items(tree["params"]):
        if w.spec and "mp" in w.spec:
            d = w.spec.index("mp")
            n = w.global_shape[d] // 2
            w.window[d] = [n - w.window[d][0], 2 * n - w.window[d][0]]
    ckpt.save_sharded(tree, os.path.join(root, "swapped"),
                      store=ckpt.ProcessGroupStore.default())
    out["mp2"] = windows(step)
    return out


def _manager(root):
    """Steps 1 and 2 saved at sharding 2; rank 1 then finds one of its
    own shard files of step 2 corrupt: every rank restores step 1."""
    from paddle_tpu_torch.train import restore_checkpoint, save_checkpoint
    ids, labels = _batch()
    step = _build("sh2_os_g", dropout=False)
    mgr = CheckpointManager(os.path.join(root, "mgr"))
    for n in (1, 2):
        step(ids, labels)
        save_checkpoint(mgr, n, step, block=True)
    me = tdist.get_rank()
    tdist.barrier()
    if me == 1:
        d = mgr.step_dir(2)
        name = "opt_tree.slots.moment1.gpt\\u002elayers\\u002e0\\u002e" \
            "attn\\u002eqkv_proj\\u002eweight"
        f = os.path.join(d, "data", ckpt._fs_name(name), "1_0.npy")
        data = bytearray(open(f, "rb").read())
        data[-1] ^= 0xFF
        open(f, "wb").write(bytes(data))
    tdist.barrier()
    fresh = _build("sh2_os_g", seed=1, dropout=False)
    return {"n": restore_checkpoint(CheckpointManager(
        os.path.join(root, "mgr")), fresh), "rank": me,
        "again": _fresh_keys(root, fresh)}


def _fresh_keys(root, step):
    """After the manager's restore: step 3 saved, then a second manager
    on that root restores with rank 1 a second late (it must not read
    the first restore's votes); and two saves to one path through
    ``fleet.save_sharded`` with rank 0 a second late on the second (rank
    1 must not pass the first save's barrier): the steps restored and
    the path's array."""
    import time
    from paddle_tpu_torch.distributed.fleet import fleet
    from paddle_tpu_torch.train import restore_checkpoint, save_checkpoint
    ids, labels = _batch()
    me = tdist.get_rank()
    step(ids, labels)
    save_checkpoint(CheckpointManager(os.path.join(root, "mgr")), 3, step,
                    block=True)
    tdist.barrier()
    if me == 1:
        time.sleep(1.0)
    n = restore_checkpoint(CheckpointManager(os.path.join(root, "mgr")),
                           _build("sh2_os_g", seed=2, dropout=False))
    path = os.path.join(root, "fleet_twice")
    for k in (1, 2):
        tdist.barrier()
        if me == 0 and k == 2:
            time.sleep(1.0)
        row = torch.full((1, 4), float(10 * k + me))
        fleet.save_sharded({"w": ckpt.HostLocalShard(
            row, [[me, me + 1], [0, 4]], (2, 4))}, path)
    tdist.barrier()
    return {"n": n, "fleet": ckpt.load_sharded(path)["w"].tolist()}


def _jax_load(name, root):
    """The JAX step's checkpoint loaded into this layout: windows."""
    step = _build(name, seed=1, dropout=False)
    template = step.checkpoint_tree()
    tree = ckpt.load_sharded(os.path.join(root, "jax"),
                             getattr(step, "checkpoint_mesh", None), None,
                             template)
    step.load_checkpoint_tree(tree, template=template)
    return step, windows(step)


def _rank(names, root, arrays, cross, jax_names):
    """Each of ``names`` (all of this world size): its resume check, its
    cross-layout save and loads (``cross``: {name: [checkpoints to
    load]}), the JAX files' load (and, at the JAX mesh, two steps on)."""
    tdist.init_parallel_env(device="cpu")
    res = {}
    for name in names:
        if name in RESUME:
            res[name] = {"resume": _resume(name, os.path.join(root, "r",
                                                              name))}
    for name, load_from in cross.items():
        res.setdefault(name, {})["cross"] = _cross(
            name, os.path.join(root, "x"), arrays, load_from)
    for name in jax_names:
        step, wins = _jax_load(name, root)
        res.setdefault(name, {})["jax"] = wins
        if name == BIG:
            from test_torch_zero import run_steps
            res[name]["jax_steps"] = rank_result(step, *run_steps(
                step, tuple(t.numpy() for t in _batch()), n=2))
    if "faults" in names:
        res["faults"] = _faults(root)
    if "manager" in names:
        res["manager"] = _manager(root)
    return res


# -- the JAX side --------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_run(root):
    """The JAX step at the mp 2 x pp 2 (v 2) x sharding 2 mesh from the
    JAX model's seed-0 weights (dropout 0): one step, its state saved as
    ``{"params", "opt_tree"}`` under ``root/jax``, two steps more; the
    initial state saved under ``root/jax0`` for the index comparison."""
    import jax
    import paddle_tpu as pt
    import paddle_tpu.distributed as jdist
    from paddle_tpu.distributed import checkpoint as jckpt
    from paddle_tpu.distributed.fleet.meta_parallel.pp_spmd import \
        natural_stack
    from paddle_tpu.distributed.sharding import group_sharded_parallel
    from paddle_tpu.distributed.train_step import build_train_step
    from paddle_tpu.incubate.models import gpt as jgpt
    dp, mp, pp, sh, level, v, _ = LAYOUTS[BIG]
    try:
        pt.seed(0)
        cfg = jgpt.gpt_tiny(**NO_DROPOUT)
        cfg.num_layers = LAYERS
        model = jgpt.GPTForCausalLM(cfg)
        crit = jgpt.GPTPretrainingCriterion()
        init = {k: np.asarray(p._data) for k, p in model.named_parameters()}
        ids, labels = (t.numpy().astype(np.int32) for t in _batch())
        mesh = jdist.init_mesh({"dp": dp, "mp": mp, "pp": pp,
                                "sharding": sh, "sep": 1},
                               devices=jax.devices()[:dp * mp * pp * sh])
        opt = pt.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=model.parameters(),
                                 grad_clip=pt.nn.ClipGradByGlobalNorm(0.5))
        model, opt, _ = group_sharded_parallel(model, opt, level=level)
        step, state = build_train_step(model, lambda lg, lb: crit(lg, lb),
                                       opt, mesh=mesh, pipeline_microbatches=M,
                                       pipeline_virtual_stages=v)
        jckpt.save_sharded({"params": state["params"],
                            "opt_tree": state["opt"]},
                           os.path.join(root, "jax0"))
        _, state = step(state, ids, labels)
        jckpt.save_sharded({"params": state["params"],
                            "opt_tree": state["opt"]},
                           os.path.join(root, "jax"))

        def unstacked(params):
            out = {}
            for k, a in params.items():
                if k.startswith("__ppstack__."):
                    nat = np.asarray(natural_stack(a, LAYERS))
                    for i in range(LAYERS):
                        out[f"gpt.layers.{i}.{k[12:]}"] = nat[i]
                else:
                    out[k] = np.asarray(a)
            return out

        after1 = unstacked(state["params"])
        losses = []
        for _ in range(2):
            loss, state = step(state, ids, labels)
            losses.append(float(loss))
        return {"init": init, "after1": after1, "losses": losses,
                "params": unstacked(state["params"]),
                "shards": device_shards(state["opt"]["slots"], mesh),
                "stacked": {"pp": pp, "v": v, "per": LAYERS // (pp * v)}}
    finally:
        jdist.set_mesh(None)
        jdist.destroy_process_group()


def _jax_norm(params):
    """The global gradient norm of the JAX model at ``params`` on the
    batch (what the port's clip reads at its first step after a load)."""
    import jax
    import jax.numpy as jnp
    import paddle_tpu as pt
    from paddle_tpu.incubate.models import gpt as jgpt
    from paddle_tpu.jit.api import functional_call
    from paddle_tpu.tensor import Tensor
    pt.seed(0)
    cfg = jgpt.gpt_tiny(**NO_DROPOUT)
    cfg.num_layers = LAYERS
    model = jgpt.GPTForCausalLM(cfg)
    crit = jgpt.GPTPretrainingCriterion()
    ids, labels = (t.numpy().astype(np.int32) for t in _batch())

    def loss_of(p):
        out, _ = functional_call(model, p, {}, (Tensor(ids),), training=True)
        return crit(out, Tensor(labels))._data

    grads = jax.grad(loss_of)({k: jnp.asarray(a) for k, a in params.items()})
    return float(jnp.sqrt(sum(jnp.sum(g * g) for g in grads.values())))


def _late(name, root, load_from):
    """This layout loads checkpoints saved after its own spawn ran."""
    tdist.init_parallel_env(device="cpu")
    out = {}
    for other in load_from:
        step = _build(name, seed=1, dropout=False)
        from paddle_tpu_torch.train import restore_checkpoint
        assert restore_checkpoint(CheckpointManager(
            os.path.join(root, "x", other)), step) == 1
        out[other] = windows(step)
    return {name: {"cross": {"loaded": out}}}


# -- the runs ------------------------------------------------------------------------

_RUNS = {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawn, once for the module: the JAX run first (its initial
    weights start every cross-layout and JAX run), the world of one
    saves in this process, then 2, 4 and 8 ranks; a later 2- and 4-rank
    spawn load what the 8-rank one saved, and the world of one loads
    everything last."""
    if not _RUNS:
        root = str(tmp_path_factory.mktemp("sharded"))
        ref = _jax_run(root)
        arrays = ref["init"]
        x = os.path.join(root, "x")
        out = {"root": root, "ref": ref,
               "w1": {"cross": _cross("w1", x, arrays, [])}}

        def run(n, fn, args):
            return spawn(fn, args=args, nprocs=n,
                         store=os.path.join(root, f"s{len(out)}"),
                         timeout=SPAWN_TIMEOUT)

        out[2] = run(2, _rank, ([n for n in RESUME if _world(n) == 2] +
                                ["faults", "manager"], root, arrays,
                                {"pp2_v1": ["w1"]}, ["pp2_v1"]))
        out[4] = run(4, _rank, ([], root, arrays,
                                {"dp2xmp2": ["w1", "pp2_v1"]}, []))
        out[8] = run(8, _rank, ([n for n in RESUME if _world(n) == 8], root,
                                arrays, {BIG: ["w1", "pp2_v1", "dp2xmp2"]},
                                [BIG]))
        out["2b"] = run(2, _late, ("pp2_v1", root, ["dp2xmp2", BIG]))
        out["4b"] = run(4, _late, ("dp2xmp2", root, [BIG]))
        loaded = {}
        for other in ("dp2xmp2", "pp2_v1", BIG):
            from paddle_tpu_torch.train import restore_checkpoint
            step = _build("w1", seed=1, dropout=False)
            assert restore_checkpoint(CheckpointManager(
                os.path.join(x, other)), step) == 1
            loaded[other] = windows(step)
        out["w1"]["cross"]["loaded"] = loaded
        out["w1"]["jax"] = _jax_load("w1", root)[1]
        _RUNS.update(out)
    yield _RUNS


def _ranks_of(runs, name):
    """The result dicts of ``name``'s ranks, every spawn merged."""
    if name == "w1":
        return [runs["w1"]]
    tags = {2: [2, "2b"], 4: [4, "4b"], 8: [8]}[_world(name)]
    merged = [dict() for _ in range(_world(name))]
    for tag in tags:
        for r, res in enumerate(runs[tag]):
            for k, v in res.get(name, {}).items():
                if k == "cross" and "cross" in merged[r]:
                    merged[r]["cross"]["loaded"].update(v["loaded"])
                else:
                    merged[r][k] = v
    return merged


def _v(name):
    return 1 if name == "w1" else LAYOUTS[name][5]


# -- the tests -----------------------------------------------------------------------

@pytest.mark.parametrize("name", RESUME)
def test_resume_gives_the_uninterrupted_bits(runs, name):
    for r in _ranks_of(runs, name):
        res = r["resume"]
        for mode in ("sync", "async"):
            got = res[mode]
            assert got["n"] == 1, (mode, got)
            assert got["losses"] == res["full"], (mode, got, res["full"])
            assert got["tensors"] and got["n_tensors"] > 10, (mode, got)
            assert got["generators"] and got["n_generators"] >= 1, \
                (mode, got)
        assert res["full"][-1] < res["full"][0]


PAIRS = [(a, b) for a in CROSS for b in CROSS if a != b]


@pytest.mark.parametrize("saver,loader", PAIRS,
                         ids=[f"{a}-to-{b}" for a, b in PAIRS])
def test_cross_layout_load_gives_the_same_global_bits(runs, saver, loader):
    saved = natural(assemble([r["cross"]["saved"]
                              for r in _ranks_of(runs, saver)]), _v(saver))
    got = natural(assemble([r["cross"]["loaded"][saver]
                            for r in _ranks_of(runs, loader)]), _v(loader))
    assert not _same(saved, got)
    assert any("__ppstack__" in str(p) for r in _ranks_of(runs, saver)
               for p, *_ in r["cross"]["saved"]) == (LAYOUTS.get(
                   saver, (1, 1, 1))[2] > 1)


def _port_dir(runs, name):
    return os.path.join(runs["root"], "x", name, "step_00000001")


def test_port_files_load_in_the_jax_package(runs):
    import jax
    import jax.numpy as jnp
    import paddle_tpu as pt
    import paddle_tpu.distributed as jdist
    from paddle_tpu.distributed import checkpoint as jckpt
    from paddle_tpu.distributed.sharding import group_sharded_parallel
    from paddle_tpu.distributed.train_step import build_train_step
    from paddle_tpu.incubate.models import gpt as jgpt
    dp, mp, pp, sh, level, v, _ = LAYOUTS[BIG]
    port = assemble([r["cross"]["saved"] for r in _ranks_of(runs, BIG)])
    try:
        pt.seed(0)
        cfg = jgpt.gpt_tiny(**NO_DROPOUT)
        cfg.num_layers = LAYERS
        model = jgpt.GPTForCausalLM(cfg)
        crit = jgpt.GPTPretrainingCriterion()
        mesh = jdist.init_mesh({"dp": dp, "mp": mp, "pp": pp,
                                "sharding": sh, "sep": 1},
                               devices=jax.devices()[:8])
        opt = pt.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=model.parameters())
        model, opt, _ = group_sharded_parallel(model, opt, level=level)
        _, state = build_train_step(model, lambda lg, lb: crit(lg, lb), opt,
                                    mesh=mesh, pipeline_microbatches=M,
                                    pipeline_virtual_stages=v)
        got = jckpt.load_sharded(_port_dir(runs, BIG), mesh, None,
                                 {"params": state["params"],
                                  "opt_tree": state["opt"]})
        flat = {p: np.asarray(a) for p, a in ckpt._flat_items(got)}
        assert not _same(port, flat)
        # onto the world of one: the per-block JAX template
        one = jdist.init_mesh({"dp": 1}, devices=jax.devices()[:1])
        pt.seed(0)
        w1 = jgpt.GPTForCausalLM(cfg)
        params = {k: p._data for k, p in w1.named_parameters()}
        jopt = pt.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=w1.parameters())
        tmpl = {"params": params, "opt_tree": jopt.init_state_tree(params)}
        got = jckpt.load_sharded(_port_dir(runs, BIG), one, None, tmpl)
        flat = {p: np.asarray(a) for p, a in ckpt._flat_items(got)}
        assert not _same(natural(port, v), flat)
        del jnp
    finally:
        jdist.set_mesh(None)
        jdist.destroy_process_group()


def test_jax_files_load_in_the_port_and_step_as_the_jax_step(runs):
    ref = runs["ref"]
    jax_dir = os.path.join(runs["root"], "jax")
    saved = {p: a for p, a in ckpt._flat_items(ckpt.load_sharded(jax_dir))
             if p[0] in ("params", "opt_tree")}
    saved = {p: a.numpy() for p, a in saved.items()}
    got = assemble([r["jax"] for r in _ranks_of(runs, BIG)])
    assert not _same(saved, got)
    for name in ("pp2_v1", "w1"):
        got = natural(assemble([r["jax"] for r in _ranks_of(runs, name)]),
                      _v(name))
        assert not _same(natural(saved, LAYOUTS[BIG][5]), got), name
    # two steps on from the JAX step's state, as the JAX step takes them
    steps = [r["jax_steps"] for r in _ranks_of(runs, BIG)]
    err = check_against_jax(steps, dict(ref, init=ref["after1"],
                                        norm=_jax_norm(ref["after1"])),
                            stacked=ref["stacked"])
    assert err["loss"] <= SLICE_TOL, err
    assert err["weight"] <= SLICE_TOL, err
    assert err["update"] <= UPDATE_RTOL, err
    assert err["moment"] <= SLICE_TOL, err
    assert err["moment_rel"] <= MOMENT_RTOL, err
    assert err["norm"] <= NORM_RTOL, err


def _index(path):
    return ckpt._merge_index(path)


def test_both_packages_write_the_same_index(runs):
    """The JAX state as ``build_train_step`` placed it (after a step the
    compiler may leave a parameter with another sharding, which the port
    reads all the same: the test above)."""
    jax_idx = _index(os.path.join(runs["root"], "jax0"))
    port_idx = {k: e for k, e in _index(_port_dir(runs, BIG)).items()
                if not k.startswith("rng.")}
    assert set(jax_idx) == set(port_idx), sorted(set(jax_idx) ^
                                                 set(port_idx))
    for leaf, want in jax_idx.items():
        got = port_idx[leaf]
        assert (got["shape"], got["dtype"], got["spec"]) == \
            (want["shape"], want["dtype"], want["spec"]), leaf
        for entry in (got, want):
            vol = sum(int(np.prod([b - a for a, b in sh["index"]]))
                      for sh in entry["shards"])
            assert vol == int(np.prod(entry["shape"])), leaf
    assert any(e["spec"] and "pp" in e["spec"] for e in port_idx.values())
    assert any(e["spec"] and "sharding" in e["spec"]
               for e in port_idx.values())


def test_manager_sends_every_rank_to_the_same_earlier_step(runs):
    got = [r["manager"] for r in runs[2]]
    assert [g["n"] for g in got] == [1, 1], got


def test_a_second_manager_restores_with_fresh_votes(runs):
    got = [r["manager"]["again"]["n"] for r in runs[2]]
    assert got == [3, 3], got


def test_fleet_saves_twice_to_one_path(runs):
    for r in runs[2]:
        assert r["manager"]["again"]["fleet"] == [[20.0] * 4, [21.0] * 4]


def test_planted_window_written_twice_fails(runs):
    with pytest.raises(ckpt.CheckpointCorruptError, match="overlap"):
        ckpt.load_sharded(os.path.join(runs["root"], "twice"))


def test_planted_swapped_windows_fail(runs):
    want = assemble([r["faults"]["mp2"] for r in runs[2]])
    got = {p: a.numpy() for p, a in ckpt._flat_items(ckpt.load_sharded(
        os.path.join(runs["root"], "swapped")))}
    params = {p: a for p, a in want.items() if p[0] == "params"}
    bad = [p for p, a in params.items() if not np.array_equal(a, got[p])]
    assert bad and len(bad) < len(params), bad


@pytest.mark.parametrize("planted", [False, True])
def test_blocks_are_numbered_from_their_names(runs, planted, monkeypatch):
    """A stacked pp 2 checkpoint into stage 1's per-block template
    (blocks 2 and 3): each row by its block's global index; numbered
    from the template's own order (the planted fault) it takes rows 0
    and 1."""
    saved = natural(assemble([r["cross"]["saved"]
                              for r in _ranks_of(runs, "pp2_v1")]), 1)
    stage = {p: torch.zeros(a.shape, dtype=torch.float32)
             for p, a in saved.items() if p[0] == "params" and
             p[1].startswith(("gpt.layers.2.", "gpt.layers.3."))}
    if planted:
        names = sorted({p[1] for p in stage})

        def by_template(name, loc):
            if not name.endswith("." + loc) or name not in names:
                return None
            return [n for n in names if n.endswith("." + loc)].index(name)

        monkeypatch.setattr(ckpt, "_block_of", by_template)
    tmpl = ckpt._unflatten({ckpt._leaf_name(p): t for p, t in stage.items()})
    got = ckpt.load_sharded(_port_dir(runs, "pp2_v1"), template=tmpl)
    bad = [p for p, a in ckpt._flat_items(got)
           if not np.array_equal(a.numpy(), saved[p])]
    assert bool(bad) == planted, bad


def test_a_window_load_reads_only_the_files_it_meets(tmp_path, monkeypatch):
    """Two ranks' windows of one leaf (rows 0-3 and 4-7) and a replicated
    leaf: loading rank 1's window reads rank 1's file of the split leaf
    and the replicated leaf's file, never rank 0's rows; a corrupt rank 0
    file does not stop it, and a whole load finds the corruption."""
    w = torch.arange(48, dtype=torch.float32).reshape(8, 6)
    path = str(tmp_path / "c")
    for proc in (0, 1):
        tree = {"w": ckpt.ShardWindow(w[4 * proc:4 * proc + 4],
                                      [[4 * proc, 4 * proc + 4], [0, 6]],
                                      (8, 6), ("dp", None)),
                "b": ckpt.ShardWindow(torch.ones(3), [[0, 3]], (3,), (),
                                      write=proc == 0)}
        ckpt.save_sharded(tree, path, proc, world_size=2)
    read = []
    real = ckpt._read_file
    monkeypatch.setattr(ckpt, "_read_file", lambda p, rel, want=None: (
        read.append(rel), real(p, rel, want))[1])
    tmpl = {"w": ckpt.ShardWindow(torch.zeros(4, 6), [[4, 8], [0, 6]],
                                  (8, 6), ("dp", None)),
            "b": torch.zeros(3)}
    got = ckpt.load_sharded(path, None, None, tmpl)
    torch.testing.assert_close(got["w"], w[4:])
    torch.testing.assert_close(got["b"], torch.ones(3))
    data = sorted(r for r in read if r.startswith("data/"))
    assert data == ["data/b/0_0.npy", "data/w/1_0.npy"], data
    bad = os.path.join(path, "data", "w", "0_0.npy")
    raw = bytearray(open(bad, "rb").read())
    raw[-1] ^= 0xFF
    open(bad, "wb").write(bytes(raw))
    torch.testing.assert_close(ckpt.load_sharded(path, None, None, tmpl)["w"],
                               w[4:])
    with pytest.raises(ckpt.CheckpointCorruptError, match="CRC32"):
        ckpt.load_sharded(path)
