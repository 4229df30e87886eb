"""``rpc``, the sharded embedding (``ps``) and the entry attributes of the
port on the CPU, held to the JAX package in the same process:

 - rpc at a world of one (``rpc_sync`` and ``rpc_async`` to itself, the
   worker table) and across two gloo ranks: a call each way, a remote
   error raised at the caller, a call past its ``timeout`` raising
   ``socket.timeout`` and one with ``timeout <= 0`` waiting it out;
 - ``ShardedEmbedding`` at a world of one against ``F.embedding`` (the
   same bits), at 2 and 4 ranks against the world of one over the ranks'
   ids one after another: each rank's rows and its window of the table's
   gradient the same bits (tolerance 0: the sorted sums of
   ``F.embedding``'s backward); the live axes filtered as the JAX
   ``ShardedEmbedding`` filters them on the same mesh;
 - ``row_sparse_apply`` and ``RowSparseAdagrad`` against the JAX
   functions on ids with repeats, within ``SPARSE_TOL`` (f32 sums in
   another order; relative for Adagrad's accumulators), only the rows
   seen touched;
 - ``ProbabilityEntry``, ``CountFilterEntry``, ``ShowClickEntry``: the
   JAX package's attribute strings and refusals.
"""
import socket
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.distributed import rpc, spawn
from paddle_tpu_torch.distributed.ps import (RowSparseAdagrad,
                                             ShardedEmbedding,
                                             row_sparse_apply)
from paddle_tpu_torch.framework.random import make_generator
from paddle_tpu_torch.nn.functional import embedding
from paddle_tpu_torch.nn.initializer import XavierNormal

SPAWN_TIMEOUT = 120
SPARSE_TOL = 1e-6
V, D, IDS = 64, 8, (3, 5)


def _add(a, b=0):
    return a + b


def _boom():
    raise KeyError("raised on the remote worker")


def _sleep(s):
    time.sleep(s)
    return s


def test_rpc_world_of_one():
    me = rpc.init_rpc("solo")
    try:
        assert me.name == "solo" and me.rank == 0 and me.ip == "127.0.0.1"
        assert rpc.rpc_sync("solo", _add, args=(2,), kwargs={"b": 3}) == 5
        assert rpc.rpc_async("solo", _add, args=(4,)).wait() == 4
        assert rpc.get_current_worker_info() is me
        assert rpc.get_worker_info("solo") is me
        assert rpc.get_all_worker_infos() == [me]
        with pytest.raises(ValueError, match="unknown rpc worker"):
            rpc.rpc_sync("nobody", _add, args=(1,))
        with pytest.raises(RuntimeError, match="already"):
            rpc.init_rpc("again")
    finally:
        rpc.shutdown()
    assert rpc.get_current_worker_info() is None


def _rpc_rank():
    tdist.init_parallel_env(device="cpu")
    r = tdist.get_rank()
    rpc.init_rpc(f"w{r}")
    other = f"w{1 - r}"
    out = {"sum": rpc.rpc_sync(other, _add, args=(10, r)),
           "async": rpc.rpc_async(other, _add, args=(r,), kwargs={"b": 5})
           .wait(),
           "names": sorted(w.name for w in rpc.get_all_worker_infos()),
           "peer_rank": rpc.get_worker_info(other).rank}
    try:
        rpc.rpc_sync(other, _boom)
        out["error"] = None
    except KeyError as e:
        out["error"] = str(e)
    try:
        rpc.rpc_sync(other, _sleep, args=(2.0,), timeout=0.3)
        out["timeout"] = None
    except socket.timeout:
        out["timeout"] = "socket.timeout"
    out["no_timeout"] = rpc.rpc_sync(other, _sleep, args=(0.5,), timeout=0)
    rpc.shutdown()
    return out


def test_rpc_across_two_ranks():
    ranks = spawn(_rpc_rank, nprocs=2, timeout=SPAWN_TIMEOUT)
    for r, out in enumerate(ranks):
        assert out["sum"] == 10 + r and out["async"] == r + 5
        assert out["names"] == ["w0", "w1"] and out["peer_rank"] == 1 - r
        assert out["error"] == "'raised on the remote worker'"
        assert out["timeout"] == "socket.timeout"
        assert out["no_timeout"] == 0.5


# -- the sharded embedding ------------------------------------------------------

def _ids(r):
    return torch.from_numpy(np.random.RandomState(r).randint(0, V, IDS))


def _gout(r):
    return torch.from_numpy(np.random.RandomState(100 + r).randn(
        *IDS, D).astype(np.float32))


def _world_of_one(n):
    """F.embedding over the table every rank draws, on the ranks' ids one
    after another: (rows, table gradient)."""
    w = XavierNormal()((V, D), make_generator(0, "cpu")).requires_grad_()
    out = embedding(torch.cat([_ids(r) for r in range(n)]), w)
    out.backward(torch.cat([_gout(r) for r in range(n)]))
    return out.detach(), w.grad


def test_sharded_embedding_world_of_one_is_f_embedding():
    emb = ShardedEmbedding(V, D, generator=make_generator(0, "cpu"))
    assert emb._shard_axes == () and emb.weight.shape == (V, D)
    out = emb(_ids(0))
    out.backward(_gout(0))
    want, grad = _world_of_one(1)
    assert torch.equal(out, want) and torch.equal(emb.weight.grad, grad)


def _emb_rank():
    tdist.init_parallel_env(device="cpu")
    r = tdist.get_rank()
    emb = ShardedEmbedding(V, D, generator=make_generator(0, "cpu"))
    out = emb(_ids(r))
    out.backward(_gout(r))
    return {"rows": out.detach(), "grad": emb.weight.grad,
            "offset": emb.weight.row_offset, "axes": emb._shard_axes,
            "spec": emb.weight.spec}


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_embedding_ranks_match_world_of_one(n):
    ranks = spawn(_emb_rank, nprocs=n, timeout=SPAWN_TIMEOUT)
    want, grad = _world_of_one(n)
    per = V // n
    offsets = sorted(res["offset"] for res in ranks)
    assert offsets == [k * per for k in range(n)]
    for r, res in enumerate(ranks):
        assert res["axes"] == ("dp",) and res["spec"] == (("dp",), None)
        rows = want[r * IDS[0]:(r + 1) * IDS[0]]
        assert torch.equal(res["rows"], rows), r
        lo = res["offset"]
        assert torch.equal(res["grad"], grad[lo:lo + per]), r


@pytest.mark.parametrize("degrees, vocab", [
    ({"dp": 2, "mp": 2}, 64), ({"dp": 2, "mp": 2}, 6),
    ({"dp": 2, "sharding": 2}, 12), ({"mp": 4}, 8)])
def test_live_axes_filter_as_jax(degrees, vocab):
    import jax
    from paddle_tpu.distributed import mesh as jmesh
    from paddle_tpu.distributed.ps import ShardedEmbedding as JEmb
    from paddle_tpu_torch.distributed import mesh as tmesh
    from paddle_tpu_torch.distributed.ps import _live_axes
    n = int(np.prod(list(degrees.values())))
    old_j, old_t = jmesh.get_mesh(False), tmesh.get_mesh(False)
    try:
        jmesh.set_mesh(jmesh.build_mesh(degrees, jax.devices()[:n]))
        tmesh.set_mesh(tmesh.build_mesh(degrees, world_size=n))
        want = JEmb(vocab, 4)._shard_axes
        assert _live_axes(vocab, ("dp", "sharding", "mp")) == want
    finally:
        jmesh.set_mesh(old_j)
        tmesh.set_mesh(old_t)


# -- row-sparse updates -----------------------------------------------------------

def _sparse_case():
    rng = np.random.RandomState(3)
    w = rng.randn(20, 6).astype(np.float32)
    ids = np.array([[3, 7, 3], [11, 7, 3]], np.int64)
    g = rng.randn(2, 3, 6).astype(np.float32)
    return w, ids, g


def test_row_sparse_apply_matches_jax():
    import jax.numpy as jnp
    from paddle_tpu.distributed.ps import row_sparse_apply as jrsa
    w, ids, g = _sparse_case()

    def upd(rows, grads):
        return rows - 0.5 * grads

    jw, juniq = jrsa(jnp.asarray(w), jnp.asarray(ids), jnp.asarray(g), upd)
    tw = torch.from_numpy(w.copy())
    out, uniq = row_sparse_apply(tw, torch.from_numpy(ids),
                                 torch.from_numpy(g), upd)
    assert out is tw
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=SPARSE_TOL,
                               rtol=0)
    assert uniq.tolist() == [3, 7, 11]
    assert [int(u) for u in np.asarray(juniq) if u < 20] == uniq.tolist()
    untouched = [i for i in range(20) if i not in (3, 7, 11)]
    assert np.array_equal(tw.numpy()[untouched], w[untouched])


def test_row_sparse_adagrad_matches_jax():
    import jax.numpy as jnp
    import paddle_tpu as pt
    from paddle_tpu.distributed.ps import RowSparseAdagrad as JAda
    w, ids, g = _sparse_case()
    jt = pt.to_tensor(w.copy())
    jopt = JAda(jt, learning_rate=0.1, epsilon=1e-8)
    tt = torch.nn.Parameter(torch.from_numpy(w.copy()))
    topt = RowSparseAdagrad(tt, learning_rate=0.1, epsilon=1e-8)
    for k in range(3):
        gk = g * (k + 1)
        jopt.step_rows(jnp.asarray(ids), jnp.asarray(gk))
        uniq = topt.step_rows(torch.from_numpy(ids), torch.from_numpy(gk))
    np.testing.assert_allclose(tt.detach().numpy(), np.asarray(jt._data),
                               atol=SPARSE_TOL, rtol=0)
    # the accumulators grow to about 25: relative
    np.testing.assert_allclose(topt._acc.numpy(), np.asarray(jopt._acc),
                               atol=0, rtol=SPARSE_TOL)
    assert uniq.tolist() == [3, 7, 11]


# -- entry attributes ---------------------------------------------------------------

def test_entry_attrs_match_jax():
    from paddle_tpu.distributed import entry_attr as je
    from paddle_tpu_torch.distributed import entry_attr as te
    pairs = [(te.ProbabilityEntry(0.25), je.ProbabilityEntry(0.25)),
             (te.CountFilterEntry(7), je.CountFilterEntry(7)),
             (te.ShowClickEntry("show", "click"),
              je.ShowClickEntry("show", "click"))]
    for t, j in pairs:
        assert t._to_attr() == j._to_attr()
    assert tdist.ProbabilityEntry is te.ProbabilityEntry
    for bad in (1, 0.0, 1.0):
        with pytest.raises(ValueError):
            je.ProbabilityEntry(bad)
        with pytest.raises(ValueError):
            te.ProbabilityEntry(bad)
    for bad in (1.5, -1):
        with pytest.raises(ValueError):
            te.CountFilterEntry(bad)
    with pytest.raises(ValueError):
        te.ShowClickEntry("show", 3)
    with pytest.raises(NotImplementedError):
        te.EntryAttr()._to_attr()
