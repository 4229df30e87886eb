"""The port's collectives on ``torch.distributed``, held row for row to
the JAX package's eager collectives, on the CPU.

The JAX package is one controller: its eager collectives take a
rank-major array (row ``i`` is rank ``i``'s value,
``tests/test_distributed.py``).  The port runs one process per rank, so
four gloo ranks, started by the port's ``spawn`` over a file store under
``tmp_path``, each pass their row and return their result; rank ``i``'s
result must equal row ``i`` of the JAX collective on the same array over
a JAX group of four devices: exactly for integers and for max / min,
within 1e-6 for float sums and averages, and within 1e-5 relative for
products (the JAX package takes a product as ``exp`` of a sum of logs).
The subgroups of ``new_group`` are held the same way.  One spawn runs
every case, each spawn bounded by ``SPAWN_TIMEOUT`` seconds.  The
ranks' function imports neither JAX nor the JAX package: JAX is imported
inside the tests.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.distributed import ReduceOp, spawn
from paddle_tpu_torch.distributed.communication import stream

N = 4
SPAWN_TIMEOUT = 60
SUM_TOL, PROD_RTOL = 1e-6, 1e-5


def _data():
    rng = np.random.RandomState(0)
    return {
        "f": rng.rand(N, 3, 2).astype(np.float32) + 0.5,
        "i": rng.randint(-50, 50, (N, 5)).astype(np.int32),
        "a2a": rng.rand(N, N, 2).astype(np.float32),
        "rs": rng.rand(N, N * 2).astype(np.float32),
        "sc": rng.rand(N, 3).astype(np.float32),
    }


def _collectives_rank(data):
    """One rank: every collective on its rows of ``data``."""
    tdist.init_parallel_env(device="cpu")
    me, out = tdist.get_rank(), {}

    def t(a):
        return torch.from_numpy(np.array(a))

    for name, op in (("sum", ReduceOp.SUM), ("max", ReduceOp.MAX),
                     ("min", ReduceOp.MIN), ("prod", ReduceOp.PROD),
                     ("avg", ReduceOp.AVG)):
        x = t(data["f"][me])
        task = tdist.all_reduce(x, op=op)
        out[f"all_reduce_{name}"] = x.numpy()
        assert task.is_completed()
    for name, op in (("sum", ReduceOp.SUM), ("max", ReduceOp.MAX),
                     ("min", ReduceOp.MIN)):
        x = t(data["i"][me])
        tdist.all_reduce(x, op=op)
        out[f"all_reduce_int_{name}"] = x.numpy()
    x = t(data["f"][me])
    task = tdist.all_reduce(x, sync_op=False)
    task.wait()
    out["all_reduce_async"] = x.numpy()
    x = t(data["f"][me])
    stream.all_reduce(x, use_calc_stream=True)
    out["stream_all_reduce"] = x.numpy()

    parts = []
    tdist.all_gather(parts, t(data["f"][me]))
    out["all_gather_list"] = np.stack([p.numpy() for p in parts])
    out["all_gather"] = tdist.all_gather(t(data["f"][me])).numpy()
    x = t(data["f"][me])
    tdist.broadcast(x, src=2)
    out["broadcast"] = x.numpy()
    x = t(data["f"][me])
    tdist.reduce(x, dst=1)
    out["reduce"] = x.numpy()
    x = torch.zeros(3)
    tdist.scatter(x, [t(r) for r in data["sc"]] if me == 0 else None, src=0)
    out["scatter"] = x.numpy()
    got = tdist.gather(t(data["f"][me]), dst=3)
    out["gather"] = [g.numpy() for g in got]
    parts = []
    tdist.alltoall(parts, [t(r) for r in data["a2a"][me]])
    out["alltoall_list"] = np.stack([p.numpy() for p in parts])
    out["alltoall"] = tdist.alltoall(t(data["a2a"][me])).numpy()
    out["alltoall_single"] = tdist.alltoall_single(t(data["rs"][me])).numpy()
    out["reduce_scatter"] = tdist.reduce_scatter(t(data["rs"][me])).numpy()
    x = torch.zeros(2)
    tdist.reduce_scatter(x, list(t(data["rs"][me]).chunk(N)))
    out["reduce_scatter_list"] = x.numpy()
    out["reduce_scatter_avg"] = tdist.reduce_scatter(
        t(data["rs"][me]), op=ReduceOp.AVG).numpy()

    # point to point around the ring
    right, left = (me + 1) % N, (me - 1) % N
    x = torch.zeros(3, 2)
    if me % 2 == 0:
        tdist.send(t(data["f"][me]), dst=right)
        tdist.recv(x, src=left)
    else:
        tdist.recv(x, src=left)
        tdist.send(t(data["f"][me]), dst=right)
    out["send_recv"] = x.numpy()
    y = torch.zeros(3, 2)
    tasks = tdist.batch_isend_irecv([
        tdist.P2POp(tdist.isend, t(data["f"][me]), right),
        tdist.P2POp(tdist.irecv, y, left)])
    for task in tasks:
        task.wait()
    out["batch_isend_irecv"] = y.numpy()
    tdist.barrier()

    objs = []
    tdist.all_gather_object(objs, {"rank": me})
    out["all_gather_object"] = objs
    box = [f"from {me}"]
    tdist.broadcast_object_list(box, src=3)
    out["broadcast_object_list"] = box
    got = []
    tdist.scatter_object_list(got, [f"to {r}" for r in range(N)]
                              if me == 1 else None, src=1)
    out["scatter_object_list"] = got

    # subgroups: every rank makes both, in the same order
    even, odd = tdist.new_group([0, 2]), tdist.new_group([1, 3])
    g = even if me % 2 == 0 else odd
    assert g.rank == me // 2 and g.nranks == 2 and g.is_member()
    assert (odd if g is even else even).rank == -1
    x = t(data["f"][me])
    tdist.all_reduce(x, group=g)
    out["group_all_reduce"] = x.numpy()
    x = t(data["f"][me])
    tdist.broadcast(x, src=g.ranks[1], group=g)
    out["group_broadcast"] = x.numpy()
    out["group_all_gather"] = tdist.all_gather(t(data["f"][me]),
                                               group=g).numpy()
    out["env"] = (tdist.get_rank(), tdist.get_world_size(),
                  tdist.get_backend(), tdist.is_initialized(),
                  tdist.ParallelEnv().local_rank, g.backend)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    store = tmp_path_factory.mktemp("collective") / "store"
    return spawn(_collectives_rank, args=(_data(),), nprocs=N,
                 store=str(store), timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def jax_out():
    """The JAX package's eager collectives over a group of 4 devices."""
    import paddle_tpu.distributed as jdist
    from paddle_tpu.tensor import Tensor
    data = _data()
    try:
        g = jdist.new_group(list(range(N)))
        f, i = data["f"], data["i"]

        def run(fn, x, **kw):
            return np.asarray(fn(Tensor(x.copy()), group=g, **kw).numpy())

        out = {}
        for name, op in (("sum", jdist.ReduceOp.SUM),
                         ("max", jdist.ReduceOp.MAX),
                         ("min", jdist.ReduceOp.MIN),
                         ("prod", jdist.ReduceOp.PROD),
                         ("avg", jdist.ReduceOp.AVG)):
            out[f"all_reduce_{name}"] = run(jdist.all_reduce, f, op=op)
        for name, op in (("sum", jdist.ReduceOp.SUM),
                         ("max", jdist.ReduceOp.MAX),
                         ("min", jdist.ReduceOp.MIN)):
            out[f"all_reduce_int_{name}"] = run(jdist.all_reduce, i, op=op)
        out["all_gather"] = run(jdist.all_gather, f)
        out["broadcast"] = run(jdist.broadcast, f, src=2)
        out["reduce"] = run(jdist.reduce, f, dst=1)
        out["scatter"] = np.asarray(jdist.scatter(
            Tensor(np.zeros((N, 3), np.float32)),
            [Tensor(r) for r in data["sc"]], src=0, group=g).numpy())
        out["gather"] = [np.asarray(x.numpy()) for x in jdist.gather(
            Tensor(f.copy()), dst=3, group=g)]
        out["alltoall"] = run(jdist.alltoall, data["a2a"])
        out["alltoall_single"] = run(jdist.alltoall_single, data["rs"])
        out["reduce_scatter"] = run(jdist.reduce_scatter, data["rs"])
        out["reduce_scatter_avg"] = run(jdist.reduce_scatter, data["rs"],
                                        op=jdist.ReduceOp.AVG)
        for ranks in ([0, 2], [1, 3]):
            sub = jdist.new_group(ranks)
            rows = f[ranks].copy()
            out[f"group_all_reduce{ranks}"] = np.asarray(jdist.all_reduce(
                Tensor(rows.copy()), group=sub).numpy())
            out[f"group_broadcast{ranks}"] = np.asarray(jdist.broadcast(
                Tensor(rows.copy()), src=ranks[1], group=sub).numpy())
            out[f"group_all_gather{ranks}"] = np.asarray(jdist.all_gather(
                Tensor(rows.copy()), group=sub).numpy())
        return out
    finally:
        jdist.set_mesh(None)
        jdist.destroy_process_group()


def _exact(got, want):
    np.testing.assert_array_equal(got, want)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=SUM_TOL)


CASES = {
    "all_reduce_sum": _close, "all_reduce_max": _exact,
    "all_reduce_min": _exact, "all_reduce_avg": _close,
    "all_reduce_int_sum": _exact, "all_reduce_int_max": _exact,
    "all_reduce_int_min": _exact, "broadcast": _exact, "reduce": _close,
    "scatter": _exact, "alltoall": _exact, "alltoall_single": _exact,
    "reduce_scatter": _close, "reduce_scatter_avg": _close,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rank_i_gets_row_i_of_the_jax_collective(results, jax_out, name):
    for rank, res in enumerate(results):
        CASES[name](res[name], jax_out[name][rank])


def test_products_match_within_their_tolerance(results, jax_out):
    for rank, res in enumerate(results):
        np.testing.assert_allclose(res["all_reduce_prod"],
                                   jax_out["all_reduce_prod"][rank],
                                   rtol=PROD_RTOL)


def test_sync_async_and_stream_all_reduce_agree(results, jax_out):
    for rank, res in enumerate(results):
        for key in ("all_reduce_async", "stream_all_reduce"):
            _close(res[key], jax_out["all_reduce_sum"][rank])


def test_gathers_and_list_forms(results, jax_out):
    f = _data()["f"]
    for rank, res in enumerate(results):
        # the JAX eager all_gather stacks the rows; the port's tensor form
        # concatenates them on axis 0, its list form is the rows
        _exact(res["all_gather"],
               jax_out["all_gather"].reshape(-1, *f.shape[2:]))
        _exact(res["all_gather_list"], jax_out["all_gather"])
        _exact(res["alltoall_list"], jax_out["alltoall"][rank])
        _close(res["reduce_scatter_list"], jax_out["reduce_scatter"][rank])
        # gather fills the list on dst alone
        if rank == 3:
            _exact(np.stack(res["gather"]), np.stack(jax_out["gather"]))
        else:
            assert res["gather"] == []


def test_point_to_point_around_the_ring(results):
    f = _data()["f"]
    for rank, res in enumerate(results):
        _exact(res["send_recv"], f[(rank - 1) % N])
        _exact(res["batch_isend_irecv"], f[(rank - 1) % N])


def test_objects_and_environment(results):
    for rank, res in enumerate(results):
        assert res["all_gather_object"] == [{"rank": r} for r in range(N)]
        assert res["broadcast_object_list"] == ["from 3"]
        assert res["scatter_object_list"] == [f"to {rank}"]
        assert res["env"] == (rank, N, "gloo", True, rank, "gloo")


def test_subgroups_match_the_jax_subgroups(results, jax_out):
    for rank, res in enumerate(results):
        ranks = [0, 2] if rank % 2 == 0 else [1, 3]
        row = ranks.index(rank)
        _close(res["group_all_reduce"],
               jax_out[f"group_all_reduce{ranks}"][row])
        _exact(res["group_broadcast"],
               jax_out[f"group_broadcast{ranks}"][row])
        _exact(res["group_all_gather"],
               jax_out[f"group_all_gather{ranks}"].reshape(-1, 2))


def _fails(rank_to_fail):
    if int(__import__("os").environ["PADDLE_TRAINER_ID"]) == rank_to_fail:
        raise RuntimeError("planted failure")
    return "done"


def _hangs():
    import time
    time.sleep(600)


def test_spawn_names_a_failed_rank_and_stops_a_hung_one(tmp_path):
    with pytest.raises(RuntimeError, match="(?s)rank 1 exited.*planted failure"):
        spawn(_fails, args=(1,), nprocs=2, timeout=SPAWN_TIMEOUT)
    with pytest.raises(TimeoutError, match="did not finish within 3"):
        spawn(_hangs, nprocs=2, timeout=3)
    assert spawn(_fails, args=(-1,), nprocs=2, store=str(tmp_path / "s"),
                 timeout=SPAWN_TIMEOUT) == ["done", "done"]


def test_bookkeeping_groups_refuse_collectives():
    # before init_parallel_env there is no group to keep books on: making
    # one, the world's collectives and its backend all raise
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        tdist.new_group([0, 1])
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        tdist.all_reduce(torch.ones(2))
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        tdist.get_backend()
    with pytest.raises(RuntimeError, match="use_calc_stream"):
        stream.all_reduce(torch.ones(2), sync_op=False, use_calc_stream=True)
