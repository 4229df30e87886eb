"""Mixture of experts and expert parallelism in the port, held to the
JAX package (``paddle_tpu/incubate/distributed/models/moe/``) on the CPU.

 - The functions: ``top1_gating`` (with and without ``prior_count``),
   ``top2_gating``, ``dispatch`` and ``combine`` against the JAX ones on
   logits leaning on one expert, so that its buffer overflows: combine,
   dispatch, the auxiliary loss, gates and mask within ``TOL``; top-2's
   second pass takes the quirk (a token its first expert dropped picks
   it again and is dropped again), seen on these logits.
 - The layer: ``MoELayer`` with ``ExpertMlp`` under the gshard, switch
   and naive gates, and with a list of ``Linear`` experts, the JAX
   layer's weights carried by name: the output, ``l_aux`` and every
   parameter's gradient of ``mean(y ** 2) + 0.01 l_aux`` within ``TOL``.
 - The dryrun's third config (``__graft_entry__.py:248-316``: E 4, D 16,
   Dff 32, gshard top-2, capacity factor 2, 16 tokens): the loss and the
   loss after one SGD step of 0.1 at ep 2, ep 4 and dp 2 x ep 2 (gloo
   ranks, ``expert_parallel_groups``) within ``TOL`` of the replicated
   run, which is within ``TOL`` of the JAX recipe; the outputs and the
   averaged gradients the replicated ones; an expert group that is not
   the world and carries no data group refused; the dp 2 x ep 2 ranks' expert
   windows (spec ``("ep", None, None)``) saved and read by the JAX
   ``load_sharded`` on a ``{"dp": 2, "ep": 2}`` mesh: the replicated
   weights' bits.
"""
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.framework.random import make_generator
from paddle_tpu_torch.incubate.distributed.models import moe as tmoe

TOL = 1e-5
SPAWN_TIMEOUT = 120
E, D, H = 4, 16, 32


def _logits(t=48, e=E, seed=0):
    """Logits leaning on expert 0: its buffer overflows at capacity
    ``t // e``."""
    rng = np.random.RandomState(seed)
    lg = rng.randn(t, e).astype(np.float32)
    lg[:, 0] += 1.5
    return lg


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


def test_top1_gating_matches_jax():
    import jax.numpy as jnp
    from paddle_tpu.incubate.distributed.models.moe import functional as jf
    lg = _logits()
    cap = 12
    want = jf.top1_gating(jnp.asarray(lg), cap)
    got = tmoe.functional.top1_gating(torch.from_numpy(lg), cap)
    for w, g in zip(want, got):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=TOL)
    assert np.asarray(want[4]).sum() < len(lg)          # capacity bites
    prior = np.full((len(lg), E), 3.0, np.float32)
    want = jf.top1_gating(jnp.asarray(lg), cap, jnp.asarray(prior))
    got = tmoe.functional.top1_gating(torch.from_numpy(lg), cap,
                                      torch.from_numpy(prior))
    for w, g in zip(want, got):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_top2_gating_dispatch_combine_match_jax(seed):
    import jax.numpy as jnp
    from paddle_tpu.incubate.distributed.models.moe import functional as jf
    lg = _logits(seed=seed)
    cap = 12
    want = jf.top2_gating(jnp.asarray(lg), cap)
    got = tmoe.functional.top2_gating(torch.from_numpy(lg), cap)
    for w, g in zip(want, got):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=TOL)
    rng = np.random.RandomState(seed)
    x = rng.randn(len(lg), D).astype(np.float32)
    ye = rng.randn(E, cap, D).astype(np.float32)
    np.testing.assert_allclose(
        _np(tmoe.functional.dispatch(torch.from_numpy(x), got[1])),
        np.asarray(jf.dispatch(jnp.asarray(x), want[1])), rtol=0, atol=TOL)
    np.testing.assert_allclose(
        _np(tmoe.functional.combine(torch.from_numpy(ye), got[0])),
        np.asarray(jf.combine(jnp.asarray(ye), want[0])), rtol=0, atol=TOL)
    # the quirk: tokens dropped by their first expert choose it again
    choices, _, _ = tmoe.functional.route(torch.from_numpy(lg), cap, 2)
    first, second = choices
    again = (~first.keep) & (second.expert == first.expert)
    assert again.any() and not second.keep[again].any()


def _jax_layer(gate, experts):
    import paddle_tpu as pt
    from paddle_tpu.incubate.distributed.models import moe as jmoe
    pt.seed(0)
    if experts == "mlp":
        ex = jmoe.ExpertMlp(E, D, H)
    else:
        ex = [pt.nn.Linear(D, D) for _ in range(E)]
    if gate == "naive1":
        g = jmoe.NaiveGate(D, E, topk=1)
    else:
        g = {"gshard": {"type": "gshard", "top_k": 2},
             "switch": {"type": "switch", "top_k": 1},
             "naive": {"type": "naive", "top_k": 2}}[gate]
    return jmoe.MoELayer(D, ex, gate=g, capacity_factor=1.0)


def _port_layer(gate, experts, arrays, moe_group=None):
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.nn.initializer import Normal
    gen = make_generator(0, "cpu")
    if experts == "mlp":
        ex = tmoe.ExpertMlp(E, D, H, generator=gen, moe_group=moe_group)
    else:
        ex = [Linear(D, D, Normal(0.02), generator=gen) for _ in range(E)]
    if gate == "naive1":
        g = tmoe.NaiveGate(D, E, topk=1, generator=gen)
    else:
        g = {"gshard": {"type": "gshard", "top_k": 2},
             "switch": {"type": "switch", "top_k": 1},
             "naive": {"type": "naive", "top_k": 2}}[gate]
    layer = tmoe.MoELayer(D, ex, gate=g, capacity_factor=1.0,
                          moe_group=moe_group, generator=gen)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            a = np.asarray(arrays[name])
            if getattr(p, "expert_axis", None) is not None:
                n = p.shape[0]
                a = a[moe_group.rank * n:(moe_group.rank + 1) * n] \
                    if moe_group is not None else a
            p.copy_(torch.from_numpy(np.ascontiguousarray(a)))
    return layer


@pytest.mark.parametrize("gate,experts", [("gshard", "mlp"),
                                          ("switch", "mlp"),
                                          ("naive", "mlp"),
                                          ("naive1", "mlp"),
                                          ("gshard", "list")])
def test_layer_matches_the_jax_layer(gate, experts):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.jit.api import functional_call
    from paddle_tpu.tensor import Tensor
    layer = _jax_layer(gate, experts)
    params = {k: p._data for k, p in layer.named_parameters()}
    x = np.random.RandomState(1).randn(2, 24, D).astype(np.float32)
    fwd = getattr(layer, "_orig_forward", layer.forward)

    def loss_of(p):
        out, _ = functional_call(layer, p, {}, (Tensor(jnp.asarray(x)),),
                                 training=True, forward_fn=fwd)
        y = out._data
        aux = layer.l_aux._data if hasattr(layer.l_aux, "_data") \
            else layer.l_aux
        return jnp.mean(y ** 2) + 0.01 * aux, (y, aux)

    (loss, (y, aux)), grads = jax.value_and_grad(loss_of, has_aux=True)(
        params)
    arrays = {k: np.asarray(v) for k, v in params.items()}
    port = _port_layer(gate, experts, arrays)
    assert sorted(n for n, _ in port.named_parameters()) == sorted(arrays)
    out = port(torch.from_numpy(x))
    got = torch.mean(out ** 2) + 0.01 * port.l_aux
    got.backward()
    np.testing.assert_allclose(_np(out), np.asarray(y), rtol=0, atol=TOL)
    np.testing.assert_allclose(float(port.l_aux), float(aux), rtol=0,
                               atol=TOL)
    assert port.gate.get_loss() is port.l_aux
    np.testing.assert_allclose(float(got), float(loss), rtol=0, atol=TOL)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(_np(p.grad), np.asarray(grads[name]),
                                   rtol=0, atol=TOL, err_msg=name)


# -- the dryrun's third config ----------------------------------------------------------

DRY_T = 16


def _dry_batch():
    return np.random.RandomState(7).randn(DRY_T, D).astype(np.float32)


def _dry_arrays():
    import paddle_tpu as pt
    from paddle_tpu.incubate.distributed.models import moe as jmoe
    pt.seed(0)
    layer = jmoe.MoELayer(D, jmoe.ExpertMlp(E, D, H),
                          gate={"type": "gshard", "top_k": 2},
                          capacity_factor=2.0)
    return layer, {k: np.asarray(p._data) for k, p in
                   layer.named_parameters()}


def _dry_step(layer, x, data_group=None):
    """The dryrun's recipe on this rank's rows: the loss (mean over every
    rank's rows), the gradients averaged over the data group, one SGD
    step of 0.1, the loss again; and the outputs and gradients."""
    params = dict(layer.named_parameters())

    def loss_of():
        out = layer(x)
        loss = (out.float() ** 2).mean()
        return out, loss

    out, loss = loss_of()
    loss.backward()
    l0 = loss.detach().clone()
    grads = {}
    for n, p in params.items():
        g = p.grad.clone()
        if data_group is not None:
            tdist.all_reduce(g, op=tdist.ReduceOp.AVG, group=data_group)
        grads[n] = g
    if data_group is not None:
        tdist.all_reduce(l0, op=tdist.ReduceOp.AVG, group=data_group)
    with torch.no_grad():
        for n, p in params.items():
            p -= 0.1 * grads[n]
            p.grad = None
        _, l1 = loss_of()
        if data_group is not None:
            tdist.all_reduce(l1, op=tdist.ReduceOp.AVG, group=data_group)
    return {"losses": [float(l0), float(l1)], "out": _np(out),
            "aux": float(layer.l_aux),
            "grads": {n: _np(g) for n, g in grads.items()}}


def _dry_rank(arrays, meshes, root):
    from paddle_tpu_torch.distributed import build_mesh
    from paddle_tpu_torch.distributed.checkpoint import (ProcessGroupStore,
                                                         save_sharded)
    from paddle_tpu_torch.distributed.checkpoint_layout import \
        module_windows
    tdist.init_parallel_env(device="cpu")
    me = tdist.get_rank()
    x = _dry_batch()
    res = {}
    for name, degrees in meshes.items():
        mesh = build_mesh(degrees)
        ep, dg = tmoe.expert_parallel_groups(mesh, me)
        layer = _port_layer("gshard", "mlp", arrays, moe_group=ep)
        layer.capacity_factor = 2.0
        coords = mesh.coords(me)
        n_dp = mesh.shape["dp"]
        rows = x.reshape(n_dp, -1, D)[coords["dp"]]
        if name == "dp2xep2":
            save_sharded({"params": module_windows(layer, mesh, me)},
                         os.path.join(root, "moe"),
                         store=ProcessGroupStore.default())
        out = _dry_step(layer, torch.from_numpy(rows),
                        dg if dg.nranks > 1 else None)
        out["coords"] = coords
        out["local"] = layer.experts.local
        res[name] = out
    if tdist.get_world_size() == 4:
        # a plain expert group of two in a world of four: the layer cannot
        # tell where the other tokens are, and refuses
        groups = [tdist.new_group([0, 1]), tdist.new_group([2, 3])]
        try:
            _port_layer("gshard", "mlp", arrays, moe_group=groups[me // 2])
            res["plain_group"] = None
        except ValueError as e:
            res["plain_group"] = str(e)
    return res


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("moe"))
    jlayer, arrays = _dry_arrays()
    ranks = {2: spawn(_dry_rank, args=(arrays, {"ep2": {"ep": 2}}, root),
                      nprocs=2, store=os.path.join(root, "s2"),
                      timeout=SPAWN_TIMEOUT),
             4: spawn(_dry_rank, args=(arrays, {"ep4": {"ep": 4},
                                                "dp2xep2": {"dp": 2,
                                                            "ep": 2}}, root),
                      nprocs=4, store=os.path.join(root, "s4"),
                      timeout=SPAWN_TIMEOUT)}
    rep = _port_layer("gshard", "mlp", arrays)
    rep.capacity_factor = 2.0
    return {"root": root, "jlayer": jlayer, "arrays": arrays,
            "replicated": _dry_step(rep, torch.from_numpy(_dry_batch())),
            "ranks": ranks}


def test_replicated_layer_matches_the_jax_dryrun_recipe(dry):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.jit.api import functional_call
    from paddle_tpu.tensor import Tensor
    layer = dry["jlayer"]
    params = {k: jnp.asarray(v) for k, v in dry["arrays"].items()}
    fwd = getattr(layer, "_orig_forward", layer.forward)

    def loss3(p, x):
        out, _ = functional_call(layer, p, {}, (Tensor(x),), training=True,
                                 forward_fn=fwd)
        return (out._data.astype(jnp.float32) ** 2).mean()

    x = jnp.asarray(_dry_batch())
    l0, g = jax.value_and_grad(loss3)(params, x)
    l1 = loss3({k: v - 0.1 * g[k] for k, v in params.items()}, x)
    got = dry["replicated"]["losses"]
    assert abs(got[0] - float(l0)) < TOL and abs(got[1] - float(l1)) < TOL
    assert got[1] < got[0]


@pytest.mark.parametrize("mesh", ["ep2", "ep4", "dp2xep2"])
def test_expert_parallel_matches_the_replicated_run(dry, mesh):
    rep = dry["replicated"]
    ranks = [r[mesh] for r in dry["ranks"][4 if mesh != "ep2" else 2]]
    n_dp = max(r["coords"]["dp"] for r in ranks) + 1
    for r in ranks:
        d0, d1 = (abs(a - b) for a, b in zip(r["losses"], rep["losses"]))
        assert d0 < TOL and d1 < TOL, (r["losses"], rep["losses"])
        assert abs(r["aux"] - rep["aux"]) < TOL
        rows = rep["out"].reshape(n_dp, -1, D)[r["coords"]["dp"]]
        np.testing.assert_allclose(r["out"], rows, rtol=0, atol=TOL)
        j, n = r["coords"]["ep"], r["local"]
        for name, g in r["grads"].items():
            want = rep["grads"][name]
            if name.startswith("experts."):
                want = want[j * n:(j + 1) * n]
            np.testing.assert_allclose(g, want, rtol=0, atol=TOL,
                                       err_msg=name)


def test_an_expert_group_without_its_data_group_is_refused(dry):
    for r in dry["ranks"][4]:
        assert r["plain_group"] and "expert_parallel_groups" in \
            r["plain_group"], r["plain_group"]


def test_expert_windows_load_in_the_jax_package(dry):
    import jax
    import paddle_tpu.distributed as jdist
    from jax.sharding import NamedSharding, PartitionSpec as P
    from paddle_tpu.distributed import checkpoint as jckpt
    try:
        mesh = jdist.init_mesh({"dp": 2, "ep": 2},
                               devices=jax.devices()[:4])
        tmpl = {}
        for k, a in dry["arrays"].items():
            spec = P("ep", *([None] * (a.ndim - 1))) \
                if k.startswith("experts.") else P()
            tmpl[k] = jax.device_put(np.zeros_like(a),
                                     NamedSharding(mesh, spec))
        got = jckpt.load_sharded(os.path.join(dry["root"], "moe"), mesh,
                                 None, {"params": tmpl})["params"]
        for k, a in dry["arrays"].items():
            np.testing.assert_array_equal(np.asarray(got[k]), a, err_msg=k)
        index = jckpt.verify_checkpoint(os.path.join(dry["root"], "moe"))
        assert index["params.experts\\u002ew1"]["spec"] == ["ep", None, None]
        assert len(index["params.experts\\u002ew1"]["shards"]) == 2
    finally:
        jdist.set_mesh(None)
        jdist.destroy_process_group()
