"""The collectives' telemetry in two gloo ranks on the CPU: each call of
each collective books one ``pt_collective_ops_total{op}``, its input
bytes (``pt_collective_bytes_total``, ``pt_collective_bytes``) and one
host-time observation (``pt_collective_time_seconds``); a
``DataParallel`` books its bucket plan once (``pt_grad_buckets_total``).
The counts are held to the calls the ranks made (the JAX package counts
once a trace, so its counts are not the reference here: ROADMAP
hazards)."""
import pytest
import torch

from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.distributed import spawn

SPAWN_TIMEOUT = 90
F32 = 4


def _rank():
    import paddle_tpu_torch.observability as tobs
    from paddle_tpu_torch.distributed import DataParallel
    tdist.init_parallel_env(device="cpu")
    me, peer = tdist.get_rank(), 1 - tdist.get_rank()
    tobs.configure(enabled=True)
    x = torch.arange(6, dtype=torch.float32) + me          # 24 bytes
    tdist.all_reduce(x)
    tdist.all_gather([], x)
    tdist.all_gather(x)
    tdist.broadcast(x, src=0)
    tdist.reduce(x, dst=0)
    out = torch.empty(3)
    tdist.scatter(out, [torch.ones(3), torch.ones(3)] if me == 0 else None,
                  src=0)
    tdist.gather(x, [], dst=0)
    tdist.alltoall([], [torch.ones(2), torch.ones(2)])
    tdist.alltoall(torch.ones(2, 3))
    tdist.alltoall_single(torch.ones(4))
    tdist.reduce_scatter(torch.empty(3), [torch.ones(3), torch.ones(3)])
    tdist.reduce_scatter(torch.ones(4))
    if me == 0:
        tdist.send(x, dst=1)
        tdist.irecv(x, src=1).wait()
    else:
        tdist.recv(x, src=0)
        tdist.isend(x, dst=0).wait()
    tasks = tdist.batch_isend_irecv([
        tdist.P2POp(tdist.isend, torch.ones(5), peer),
        tdist.P2POp(tdist.irecv, torch.empty(5), peer)])
    for t in tasks:
        t.wait()
    tdist.barrier()
    tdist.all_gather_object([], {"not": "counted"})
    model = DataParallel(torch.nn.Linear(4, 2))
    model(torch.ones(3, 4)).sum().backward()
    snap = tobs.get_registry().snapshot()
    tobs.reset()
    return snap


@pytest.fixture(scope="module")
def snaps(tmp_path_factory):
    store = tmp_path_factory.mktemp("telemetry_collective") / "store"
    return spawn(_rank, nprocs=2, store=str(store), timeout=SPAWN_TIMEOUT)


def _series(snap, name):
    return {k: (v["count"] if snap[name]["kind"] == "histogram" else v)
            for k, v in snap[name]["series"].items()}


def _want(rank):
    """{op: (calls, input bytes)} of one rank's calls above; the
    DataParallel of Linear(4, 2) broadcasts its 2 parameters and
    all-reduces its one 40-byte bucket."""
    want = {
        "all_reduce": (2, 24 + 40),
        "all_gather": (2, 48),
        "broadcast": (3, 24 + 32 + 8),
        "reduce": (1, 24),
        "scatter": (1, 24 if rank == 0 else 12),
        "gather": (1, 24),
        "alltoall": (2, 16 + 24),
        "alltoall_single": (1, 16),
        "reduce_scatter": (2, 24 + 16),
        "send": (2, 24 + 20),
        "recv": (2, 24 + 20),
        "barrier": (1, 0),
    }
    return want


@pytest.mark.parametrize("rank", [0, 1])
def test_each_call_books_its_count_and_bytes(snaps, rank):
    snap = snaps[rank]
    want = _want(rank)
    assert _series(snap, "pt_collective_ops_total") == {
        f"op={op}": float(n) for op, (n, _) in want.items()}
    assert _series(snap, "pt_collective_bytes_total") == {
        f"op={op}": float(b) for op, (_, b) in want.items() if b}
    assert _series(snap, "pt_collective_bytes") == {
        f"op={op}": n for op, (n, b) in want.items() if b}


@pytest.mark.parametrize("rank", [0, 1])
def test_each_eager_call_books_its_host_time(snaps, rank):
    # batch_isend_irecv's operations are counted as send / recv but timed
    # as one call of neither
    times = _series(snaps[rank], "pt_collective_time_seconds")
    want = {f"op={op}": n for op, (n, _) in _want(rank).items()}
    want["op=send"] -= 1
    want["op=recv"] -= 1
    assert times == want


def test_the_bucket_plan_is_booked_once(snaps):
    for snap in snaps:
        assert _series(snap, "pt_grad_buckets_total") == {
            "kind=all_reduce": 1.0}
        assert _series(snap, "pt_grad_bucket_bytes") == {"": 1}
        assert snap["pt_grad_bucket_bytes"]["series"][""]["sum"] == 40.0
