"""The port's auto-parallel layer on the CPU, held to the JAX package in
the same process, weights carried by name (``params_from_numpy``):

 - ``_placements_to_spec`` equals the JAX function over a grid of meshes
   and placements;
 - in a 2-rank and a 4-rank gloo spawn, each rank's ``shard_tensor``
   window equals the shard the JAX ``NamedSharding`` puts on the device
   of the same place in the mesh (the 8 virtual CPU devices), a
   ``reshard`` to other placements equals the JAX ``reshard``'s shard,
   and back gives the first window; ``Partial`` sums the ranks' values;
 - ``Engine`` on ``bert_tiny``'s ``BertForSequenceClassification`` at
   dropout 0, ``shuffle=False``, AdamW(1e-3), 2 epochs of 4 batches of 4:
   ``fit``'s history, ``evaluate``'s loss and accuracy and ``predict``'s
   outputs within ``TOL`` of the JAX Engine's (run once for the module,
   on a ``{"dp": 2}`` mesh) at a world of one, and in 2-rank spawns at dp
   2 and at sharding 2 (stage 2, ``os_g``); mp 2 of a BERT refused;
 - ``save`` by either package loads in the other (parameters and moments
   the same bits), the sharding-2 ranks' windows too; ``restore_latest``
   resumes to the uninterrupted losses and finds nothing in an empty
   root; ``to_static``; no optimizer, a ``scaler`` and fp16 refused;
 - GPT through ``Engine.fit`` at a world of one against
   ``build_train_step`` on the same weights and batches (dropout 0.1),
   and a whole GPT built before ``fleet.init`` cut by the Engine at mp 2
   and at pp 2 (2-rank spawns, dropout 0): the world of one's losses
   within ``TOL``;
 - ``Cluster.auto_detect`` on the CPU, and ``parallel_cost.predict``
   equal to the JAX function for the same ``Cluster`` fields (the JAX
   efficiency set to the port's, which is checked against its
   derivation).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import (Engine, Partial, ProcessMesh,
                                          Replicate, Shard, fleet, reshard,
                                          shard_tensor, spawn)
from paddle_tpu_torch.distributed.auto_parallel_api import \
    _placements_to_spec
from paddle_tpu_torch.framework.random import make_generator
from paddle_tpu_torch.incubate.models import bert as tbert
from paddle_tpu_torch.incubate.models import params_from_numpy

TOL = 1e-5
SPAWN_TIMEOUT = 180
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
N_SAMPLES, SEQ, BATCH, EPOCHS, LR = 16, 32, 4, 2, 1e-3
_X = np.random.RandomState(0).randint(0, 1024, (N_SAMPLES, SEQ)).astype(
    np.int64)
_Y = np.random.RandomState(1).randint(0, 2, (N_SAMPLES,)).astype(np.int64)


class _Data(tio.Dataset):
    def __getitem__(self, i):
        return _X[i], _Y[i]

    def __len__(self):
        return N_SAMPLES


class _JData(pt.io.Dataset):
    def __getitem__(self, i):
        return _X[i], _Y[i]

    def __len__(self):
        return N_SAMPLES


# -- placements and windows ---------------------------------------------------------

_MESHES = [((2,), ["x"]), ((2, 2), ["x", "y"]), ((2, 4), ["dp", "mp"])]
_PLACEMENTS = [Replicate(), Shard(0), Shard(1), Shard(-1), Partial()]


def _jax_placement(p):
    from paddle_tpu.distributed import auto_parallel_api as ja
    if isinstance(p, Shard):
        return ja.Shard(p.dim)
    return ja.Partial() if isinstance(p, Partial) else ja.Replicate()


@pytest.mark.parametrize("shape, names", _MESHES)
def test_placements_to_spec_matches_jax(shape, names):
    import itertools
    from paddle_tpu.distributed import auto_parallel_api as ja
    ids = np.arange(int(np.prod(shape))).reshape(shape)
    jm, tm = ja.ProcessMesh(ids, names), ProcessMesh(ids, names)
    assert tm.process_ids == jm.process_ids and tm.shape == jm.shape
    for pls in itertools.product(_PLACEMENTS, repeat=len(shape)):
        for ndim in (2, 3):
            want = ja._placements_to_spec([_jax_placement(p) for p in pls],
                                          ndim, jm)
            assert _placements_to_spec(pls, ndim, tm) == tuple(want), pls


#: (mesh shape, names, placements, then the reshard's placements)
_CASES = {
    2: [((2,), ["x"], [Shard(0)], [Shard(1)]),
        ((2,), ["x"], [Shard(1)], [Replicate()]),
        ((2,), ["x"], [Replicate()], [Shard(0)])],
    4: [((2, 2), ["x", "y"], [Shard(0), Shard(1)], [Replicate(), Shard(0)]),
        ((2, 2), ["x", "y"], [Shard(0), Shard(0)], [Shard(1), Replicate()]),
        ((2, 2), ["x", "y"], [Replicate(), Shard(1)], [Shard(1), Shard(0)]),
        ((4,), ["x"], [Shard(0)], [Shard(1)])],
}
_FULL = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)


def _window_rank(n):
    tdist.init_parallel_env(device="cpu")
    r = tdist.get_rank()
    out = []
    for shape, names, pls, other in _CASES[n]:
        mesh = ProcessMesh(np.arange(n).reshape(shape), names)
        t = shard_tensor(torch.from_numpy(_FULL), mesh, pls)
        moved = reshard(t, mesh, other)
        back = reshard(moved, mesh, pls)
        out.append({"window": t.numpy(), "moved": moved.numpy(),
                    "back": back.numpy(), "global": t.global_shape,
                    "mesh": t.process_mesh == mesh})
    mesh = ProcessMesh(np.arange(n).reshape(2, n // 2), ["x", "y"])
    part = shard_tensor(torch.full((3,), float(r + 1)), mesh,
                        [Partial(), Replicate()])
    return out, part.numpy()


def _jax_shards(shape, names, pls, n):
    """{process id: its shard} of the JAX shard_tensor and of its
    reshard."""
    from paddle_tpu.distributed import auto_parallel_api as ja
    mesh = ja.ProcessMesh(np.arange(n).reshape(shape), names)
    t = ja.shard_tensor(_FULL.copy(), mesh, [_jax_placement(p) for p in pls])
    return mesh, {s.device.id: np.asarray(s.data)
                  for s in t._data.addressable_shards}


@pytest.mark.parametrize("n", [2, 4])
def test_shard_tensor_windows_match_jax_named_sharding(n):
    from paddle_tpu.distributed import auto_parallel_api as ja
    ranks = spawn(_window_rank, args=(n,), nprocs=n, timeout=SPAWN_TIMEOUT)
    for c, (shape, names, pls, other) in enumerate(_CASES[n]):
        mesh, want = _jax_shards(shape, names, pls, n)
        moved = ja.reshard(pt.to_tensor(_FULL.copy()), mesh,
                           [_jax_placement(p) for p in other])
        want_moved = {s.device.id: np.asarray(s.data)
                      for s in moved._data.addressable_shards}
        for r in range(n):
            got = ranks[r][0][c]
            assert got["mesh"] and got["global"] == _FULL.shape
            assert np.array_equal(got["window"], want[r]), (c, r)
            assert np.array_equal(got["moved"], want_moved[r]), (c, r)
            assert np.array_equal(got["back"], want[r]), (c, r)
    # Partial over x: the ranks of a column of the 2 x (n/2) mesh summed
    for r in range(n):
        col = [q for q in range(n) if q % (n // 2) == r % (n // 2)]
        assert np.array_equal(ranks[r][1],
                              np.full(3, float(sum(q + 1 for q in col))))


# -- the Engine on BERT -----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_engine(tmp_path_factory):
    """The JAX Engine's run: its initial weights, fit history, evaluate,
    predict, final weights and saved state."""
    import jax
    from paddle_tpu.distributed import mesh as jmesh
    from paddle_tpu.distributed.auto_parallel import Engine as JEngine
    from paddle_tpu.incubate.models import bert as jbert
    pt.seed(0)
    net = jbert.BertForSequenceClassification(jbert.bert_tiny(**NO_DROPOUT))
    init = {k: np.asarray(p._data) for k, p in net.named_parameters()}
    eng = JEngine(net, loss=pt.nn.CrossEntropyLoss(),
                  optimizer=pt.optimizer.AdamW(learning_rate=LR,
                                               parameters=net.parameters()),
                  metrics=pt.metric.Accuracy(),
                  mesh=jmesh.build_mesh({"dp": 2}, jax.devices()[:2]))
    hist = eng.fit(_JData(), batch_size=BATCH, epochs=EPOCHS, shuffle=False,
                   verbose=0)
    ev = eng.evaluate(_JData(), batch_size=BATCH, verbose=0)
    pred = eng.predict(_JData(), batch_size=BATCH)
    path = str(tmp_path_factory.mktemp("jax_engine") / "state")
    eng.save(path)
    final = {k: np.asarray(v) for k, v in eng._state["params"].items()}
    moments = {k: np.asarray(v)
               for k, v in eng._state["opt"]["slots"]["moment1"].items()}
    return {"init": init, "hist": hist, "eval": ev, "pred": pred,
            "path": path, "final": final, "moment1": moments}


def _port_engine(arrays, **kw):
    gen = make_generator(0, "cpu")
    net = tbert.BertForSequenceClassification(tbert.bert_tiny(**NO_DROPOUT),
                                              generator=gen)
    params_from_numpy(net, arrays)
    return Engine(net, loss=tnn.CrossEntropyLoss(),
                  optimizer=topt.AdamW(learning_rate=LR,
                                       parameters=net.parameters()),
                  metrics=tmetric.Accuracy(), generator=gen, **kw)


def _jax_fresh(arrays):
    from paddle_tpu.distributed.auto_parallel import Engine as JEngine
    from paddle_tpu.incubate.models import bert as jbert
    net = jbert.BertForSequenceClassification(jbert.bert_tiny(**NO_DROPOUT))
    for k, p in net.named_parameters():
        p._data = pt.to_tensor(arrays[k])._data
    return JEngine(net, loss=pt.nn.CrossEntropyLoss(),
                   optimizer=pt.optimizer.AdamW(learning_rate=LR,
                                                parameters=net.parameters()),
                   metrics=pt.metric.Accuracy())


def _check_run(hist, ev, pred, want):
    np.testing.assert_allclose(hist["loss"], want["hist"]["loss"], atol=TOL,
                               rtol=0)
    assert ev.keys() == want["eval"].keys() == {"loss", "acc"}
    assert abs(ev["loss"] - want["eval"]["loss"]) <= TOL
    assert abs(ev["acc"] - want["eval"]["acc"]) <= TOL
    assert len(pred) == len(want["pred"]) == N_SAMPLES // BATCH
    for a, b in zip(pred, want["pred"]):
        assert a.shape == (BATCH, 2)
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)


def _params(eng):
    return {k: p.detach().numpy().copy()
            for k, p in eng.train_step.params.items()}


def test_engine_world_of_one_matches_jax(jax_engine, tmp_path):
    eng = _port_engine(jax_engine["init"])
    hist = eng.fit(_Data(), batch_size=BATCH, epochs=EPOCHS, shuffle=False,
                   verbose=0)
    ev = eng.evaluate(_Data(), batch_size=BATCH, verbose=0)
    pred = eng.predict(_Data(), batch_size=BATCH)
    _check_run(hist, ev, pred, jax_engine)
    assert eng.history is hist and type(eng.train_step).__name__ == \
        "TrainStep"
    assert eng.train_step.captured.stats["fallback"] == "cpu"
    # the port's save in the JAX Engine
    path = str(tmp_path / "port_state")
    eng.save(path)
    je = _jax_fresh(jax_engine["init"])
    je.load(path)
    for k, v in _params(eng).items():
        assert np.array_equal(np.asarray(je._state["params"][k]), v), k
    for k, v in eng.train_step.state["slots"]["moment1"].items():
        assert np.array_equal(
            np.asarray(je._state["opt"]["slots"]["moment1"][k]), v.numpy())
    assert int(je._state["opt"]["step"]) == eng.train_step.state["step"]


def test_jax_engine_save_loads_in_the_port(jax_engine):
    eng = _port_engine(jax_engine["init"])
    eng.load(jax_engine["path"])
    for k, v in _params(eng).items():
        assert np.array_equal(v, jax_engine["final"][k]), k
    for k, v in eng.train_step.state["slots"]["moment1"].items():
        assert np.array_equal(v.numpy(), jax_engine["moment1"][k]), k
    assert int(eng.train_step.state["step"]) == EPOCHS * N_SAMPLES // BATCH
    ev = eng.evaluate(_Data(), batch_size=BATCH, verbose=0)
    assert abs(ev["loss"] - jax_engine["eval"]["loss"]) <= TOL


def test_restore_latest_resumes_to_the_uninterrupted_losses(jax_engine,
                                                           tmp_path):
    from paddle_tpu_torch.distributed import CheckpointManager
    whole = _port_engine(jax_engine["init"])
    want = whole.fit(_Data(), batch_size=BATCH, epochs=EPOCHS, shuffle=False,
                     verbose=0)["loss"]
    a = _port_engine(jax_engine["init"])
    first = a.fit(_Data(), batch_size=BATCH, epochs=1, shuffle=False,
                  verbose=0)["loss"]
    mgr = CheckpointManager(str(tmp_path / "root"))
    a.save(mgr.step_dir(4))
    b = _port_engine({k: v * 0 for k, v in jax_engine["init"].items()})
    assert b.restore_latest(str(tmp_path / "empty")) is None
    assert b.restore_latest(mgr.root) == 4
    rest = b.fit(_Data(), batch_size=BATCH, epochs=1, shuffle=False,
                 verbose=0)["loss"]
    assert first + rest == want
    for k, v in _params(b).items():
        assert np.array_equal(v, _params(whole)[k]), k


def test_to_static_and_refusals(jax_engine):
    from paddle_tpu_torch.distributed import to_static
    gen = make_generator(0, "cpu")
    net = tbert.BertForSequenceClassification(tbert.bert_tiny(**NO_DROPOUT),
                                              generator=gen)
    eng = to_static(net, loss=tnn.CrossEntropyLoss())
    assert isinstance(eng, Engine) and eng._model is net
    assert eng.main_program is None and eng.serial_main_program is None
    with pytest.raises(ValueError, match="optimizer"):
        eng.fit(_Data(), batch_size=BATCH, verbose=0)
    # an engine without an optimizer still evaluates the model as it is
    ev = eng.evaluate(_Data(), batch_size=BATCH, verbose=0)
    assert set(ev) == {"loss"} and np.isfinite(ev["loss"])
    with pytest.raises(TypeError):
        Engine(object())
    with pytest.raises(NotImplementedError, match="item 9"):
        Engine(net, scaler=object())
    s = fleet.DistributedStrategy()
    s.amp = True
    s.amp_configs = {"use_bf16": False}
    with pytest.raises(NotImplementedError, match="item 9"):
        Engine(net, loss=tnn.CrossEntropyLoss(), strategy=s,
               optimizer=topt.AdamW(1e-3)).prepare()


def test_gpt_engine_fit_is_build_train_step():
    from paddle_tpu_torch.incubate.models import (GPTForCausalLM,
                                                  GPTPretrainingCriterion,
                                                  gpt_tiny)
    from paddle_tpu_torch.train import build_train_step, make_batch
    cfg = gpt_tiny()
    batches = [make_batch(cfg, 2, 64, seed=s, device="cpu")
               for s in range(3)]
    gen = make_generator(0, "cpu")
    net = GPTForCausalLM(cfg, generator=gen)
    eng = Engine(net, loss=GPTPretrainingCriterion(),
                 optimizer=topt.AdamW(learning_rate=1e-4,
                                      multi_precision=True),
                 generator=gen)
    losses = []
    from paddle_tpu_torch.hapi.callbacks import Callback

    class Losses(Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(float(logs["loss"]))

    eng.fit(batches, epochs=1, verbose=0, callbacks=[Losses()])
    bare = build_train_step(cfg, device="cpu", seed=0, amp_o2=False)
    want = [bare(ids, labels).item() for ids, labels in batches]
    np.testing.assert_allclose(losses, want, atol=TOL, rtol=0)
    for k, p in eng.train_step.params.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   bare.params[k].detach().numpy(),
                                   atol=TOL, rtol=0, err_msg=k)


def _engine_rank(kind, arrays, root):
    tdist.init_parallel_env(device="cpu")
    s = fleet.DistributedStrategy()
    if kind == "sharding":
        s.sharding = True
        s.sharding_configs = {"stage": 2}
        s.hybrid_configs = {"sharding_degree": 2}
    eng = _port_engine(arrays, strategy=s)
    hist = eng.fit(_Data(), batch_size=BATCH, epochs=EPOCHS, shuffle=False,
                   verbose=0)
    ev = eng.evaluate(_Data(), batch_size=BATCH, verbose=0)
    pred = eng.predict(_Data(), batch_size=BATCH)
    step = eng.train_step
    out = {"hist": hist, "eval": ev, "pred": pred,
           "degrees": (step.hcg.get_data_parallel_world_size(),
                       step.hcg.get_sharding_parallel_world_size()),
           "level": getattr(step.zero, "level", None),
           "params": {k: p.detach().numpy().copy()
                      for k, p in step.params.items()}}
    if kind == "sharding":
        eng.save(root)
        # rank 0 hosts the store the save's barrier polls: stay until both
        # have left it
        tdist.barrier()
    else:
        bad = fleet.DistributedStrategy()
        bad.hybrid_configs = {"mp_degree": 2}
        try:
            _port_engine(arrays, strategy=bad).prepare()
            out["mp"] = None
        except NotImplementedError as e:
            out["mp"] = str(e)
    return out


@pytest.mark.parametrize("kind", ["dp", "sharding"])
def test_engine_two_ranks_match_jax(kind, jax_engine, tmp_path):
    root = str(tmp_path / "sharded")
    ranks = spawn(_engine_rank, args=(kind, jax_engine["init"], root),
                  nprocs=2, timeout=SPAWN_TIMEOUT)
    for res in ranks:
        _check_run(res["hist"], res["eval"], res["pred"], jax_engine)
        assert res["degrees"] == ((2, 1) if kind == "dp" else (1, 2))
    if kind == "dp":
        assert ranks[0]["level"] is None
        assert "GPTForCausalLM only" in ranks[0]["mp"]
        return
    assert ranks[0]["level"] == "os_g"
    for k, v in ranks[0]["params"].items():
        assert np.array_equal(v, ranks[1]["params"][k]), k
    # the ranks' windows in the JAX Engine
    je = _jax_fresh(jax_engine["init"])
    je.load(root)
    for k, v in ranks[0]["params"].items():
        assert np.array_equal(np.asarray(je._state["params"][k]), v), k


# -- the cluster and the cost model -------------------------------------------------------

def test_cluster_auto_detect_on_the_cpu():
    from paddle_tpu.distributed.auto_parallel.cluster import Cluster as JC
    from paddle_tpu_torch.distributed.auto_parallel.cluster import (
        CHIP_SPECS, Cluster)
    c = Cluster.auto_detect()
    assert (c.device_kind, c.num_chips) == ("cpu", 1)
    assert (c.peak_flops, c.hbm_bytes, c.ici_bandwidth, c.chips_per_host) \
        == CHIP_SPECS["cpu"]
    assert c.to_dict().keys() == JC().to_dict().keys()
    assert Cluster.spec_of("NVIDIA H100 80GB HBM3") == CHIP_SPECS[
        "NVIDIA H100"] and CHIP_SPECS["NVIDIA H100"][0] == 989e12
    assert Cluster.spec_of("NVIDIA H100 PCIe") == CHIP_SPECS[
        "NVIDIA H100 PCIe"]
    big = Cluster(num_chips=16, num_slices=2)
    jbig = JC(**{k: v for k, v in big.to_dict().items()})
    for deg in (1, 2, 8, 16):
        assert big.bandwidth(deg) == jbig.bandwidth(deg)
    eng = Engine(torch.nn.Linear(2, 2))
    assert eng.cluster.device_kind == "cpu"


_MODEL = {"n_params": 354871296, "num_layers": 24, "hidden_size": 1024,
          "seq_len": 1024, "vocab_size": 50304}


@pytest.mark.parametrize("cfg", [
    {}, {"dp_degree": 8}, {"mp_degree": 2, "pp_degree": 2},
    {"dp_degree": 2, "sharding_degree": 4, "use_recompute": True},
    {"pp_degree": 4, "micro_batch_size": 2, "global_batch_size": 64},
    {"mp_degree": 8, "dp_degree": 4}])
def test_parallel_cost_matches_jax(cfg, monkeypatch):
    from paddle_tpu.cost_model import parallel_cost as jpc
    from paddle_tpu.distributed.auto_parallel.cluster import Cluster as JC
    from paddle_tpu_torch.cost_model import parallel_cost as tpc
    from paddle_tpu_torch.distributed.auto_parallel.cluster import Cluster
    monkeypatch.setattr(jpc, "_MFU_EFF", tpc._MFU_EFF)
    cluster = Cluster(num_chips=32, num_slices=4)
    jcluster = JC(**cluster.to_dict())
    got = tpc.predict(_MODEL, cfg, cluster, global_batch_size=32)
    want = jpc.predict(_MODEL, cfg, jcluster, global_batch_size=32)
    assert got == pytest.approx(want, rel=1e-12)
    eng = Engine(torch.nn.Linear(2, 2), cluster=cluster)
    assert eng.estimate_cost(_MODEL, cfg, 32) == got


def test_efficiency_is_the_headline_steps():
    from paddle_tpu_torch.cost_model import parallel_cost as tpc
    m = _MODEL
    flops = (6 * m["n_params"] + 6 * m["num_layers"] * m["seq_len"] *
             m["hidden_size"]) * 8 * m["seq_len"]
    assert round(flops / (0.07896 * 989e12), 3) == tpc._MFU_EFF


def _gpt_engine_rank(batches, kind):
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.incubate.models import (GPTForCausalLM,
                                                  GPTPretrainingCriterion,
                                                  gpt_tiny)
    tdist.init_parallel_env(device="cpu")
    gen = make_generator(0, "cpu")
    # built whole, before fleet.init: the Engine cuts it
    net = GPTForCausalLM(gpt_tiny(**NO_DROPOUT), generator=gen)
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {f"{kind}_degree": 2}
    eng = Engine(net, loss=GPTPretrainingCriterion(), strategy=s,
                 optimizer=topt.AdamW(learning_rate=1e-3), generator=gen)
    losses = []

    class Losses(Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(float(logs["loss"]))

    eng.fit(batches, epochs=1, verbose=0, callbacks=[Losses()])
    hcg = eng.train_step.hcg
    return {"losses": losses,
            "degrees": (hcg.get_model_parallel_world_size(),
                        hcg.get_pipe_parallel_world_size()),
            "mp_group": eng._model.mp_group is not None}


@pytest.mark.parametrize("kind", ["mp", "pp"])
def test_gpt_engine_cuts_a_whole_model(kind):
    from paddle_tpu_torch.incubate.models import gpt_tiny
    from paddle_tpu_torch.train import build_train_step, make_batch
    cfg = gpt_tiny(**NO_DROPOUT)
    batches = [make_batch(cfg, 4, 64, seed=s, device="cpu")
               for s in range(3)]
    one = build_train_step(cfg, device="cpu", seed=0, amp_o2=False,
                           optimizer=topt.AdamW(learning_rate=1e-3))
    want = [one(ids, labels).item() for ids, labels in batches]
    ranks = spawn(_gpt_engine_rank, args=(batches, kind), nprocs=2,
                  timeout=SPAWN_TIMEOUT)
    for res in ranks:
        assert res["degrees"] == ((2, 1) if kind == "mp" else (1, 2))
        assert res["mp_group"] == (kind == "mp")
        np.testing.assert_allclose(res["losses"], want, atol=TOL, rtol=0)
