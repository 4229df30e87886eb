"""The port's input pipeline, ``save`` / ``load`` and metrics
(``paddle_tpu_torch.{io,framework.io_state,metric,batch}``) on the CPU,
each held against the JAX package in the same process on the same numpy
data:

 - samplers: the same indices as the JAX package's under the same seeds
   (an injected ``RandomState`` / ``Generator``, numpy's global stream,
   ``RandomState(epoch)``), index for index;
 - the DataLoader: the same batches as the JAX package's (values and
   dtypes) with 0 and 2 workers, in iterable mode, with nested dict and
   tuple samples, and the same mid-epoch ``state_dict``; the JAX
   package's ``tests/test_io_resume.py`` contracts on the port (a resumed
   trajectory the same bits as the uninterrupted one, the roll-over at
   the epoch boundary, no data fetched for skipped batches, the sampler
   state round trip, a SIGKILLed worker named with its last batch); a
   worker's error re-raised with its traceback; an early stop leaving no
   worker alive and no shared-memory segment of theirs behind;
 - ``save`` / ``load``: an f32 state dict saved by either package loads
   in the other with the same bits; bf16 port to port; the JAX package's
   bf16 (``ml_dtypes``) read by the port; a port bf16 leaf read by the
   JAX package as its ``uint16`` bits (the cross-package hazard, pinned);
   a class outside the allowed set refused;
 - every metric equal to the JAX package's on the same predictions.
"""
import collections
import multiprocessing
import os
import pickle
import signal
import time

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.io as jio
from paddle_tpu import batch as jbatch
from paddle_tpu import metric as jmetric
from paddle_tpu.framework import io_state as jio_state
from paddle_tpu_torch.batch import batch as tbatch
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch.framework import io_state


def _np(x):
    """A batch leaf of either package as numpy."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "_data"):
        return np.asarray(x._data)
    return np.asarray(x)


def _tree(x):
    """A batch of either package as nested lists / dicts of numpy."""
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not (x and isinstance(x[0], str)):
        return [_tree(v) for v in x]
    if isinstance(x, list):
        return list(x)
    return _np(x)


def _assert_same(a, b):
    a, b = _tree(a), _tree(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, list) and a and isinstance(a[0], str):
        assert a == b
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        # the JAX package's Tensor holds int64 as int32 and f64 as f32
        # (jax without x64): the port's values, cast to those, are its
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.astype(b.dtype), b)


class _Arange(tio.Dataset):
    def __init__(self, n=24, dim=3):
        self.n, self.dim = n, dim

    def __getitem__(self, i):
        return np.full((self.dim,), float(i), np.float64)

    def __len__(self):
        return self.n


class _JArange(jio.Dataset):
    def __init__(self, n=24, dim=3):
        self.n, self.dim = n, dim

    def __getitem__(self, i):
        return np.full((self.dim,), float(i), np.float64)

    def __len__(self):
        return self.n


def _sample(i):
    """A nested sample: an image, an int label, a float, a dict with a
    string and a tuple."""
    rng = np.random.RandomState(i)
    return (rng.randn(2, 3).astype(np.float32), i % 5, float(i) / 7,
            {"name": f"s{i}", "pair": (np.int64(i), rng.randn(4)),
             "mask": rng.rand(3) > 0.5})


class _Nested(tio.Dataset):
    def __getitem__(self, i):
        return _sample(i)

    def __len__(self):
        return 10


class _JNested(jio.Dataset):
    def __getitem__(self, i):
        return _sample(i)

    def __len__(self):
        return 10


class _Stream(tio.IterableDataset):
    def __iter__(self):
        for i in range(11):
            yield np.arange(i, i + 3, dtype=np.int64), float(i)


class _JStream(jio.IterableDataset):
    def __iter__(self):
        for i in range(11):
            yield np.arange(i, i + 3, dtype=np.int64), float(i)


def _local(base):
    """A subclass of ``base`` defined in a function: it does not pickle,
    so a loader forks its workers for it (spawned workers import this
    module, and with it the JAX package: seconds each)."""
    class Local(base):
        pass
    return Local


# -- samplers -------------------------------------------------------------------

def _sampler_pairs():
    """(name, build(module, dataset class)) for every sampler."""
    return [
        ("sequence", lambda m, d: list(m.SequenceSampler(d(10)))),
        ("random_state", lambda m, d: list(m.RandomSampler(
            d(16), generator=np.random.RandomState(7)))),
        ("generator", lambda m, d: list(m.RandomSampler(
            d(16), generator=np.random.default_rng(7)))),
        ("replacement_state", lambda m, d: list(m.RandomSampler(
            d(16), replacement=True, num_samples=30,
            generator=np.random.RandomState(3)))),
        ("replacement_generator", lambda m, d: list(m.RandomSampler(
            d(16), replacement=True, num_samples=30,
            generator=np.random.default_rng(3)))),
        ("global_stream", lambda m, d: (np.random.seed(11), list(
            m.RandomSampler(d(20))))[1]),
        ("subset", lambda m, d: (np.random.seed(5), list(
            m.SubsetRandomSampler([3, 9, 4, 17, 8])))[1]),
        ("weighted", lambda m, d: (np.random.seed(5), list(
            m.WeightedRandomSampler([0.1, 0.5, 0.2, 0.2], 12)))[1]),
        ("batch_shuffle", lambda m, d: (np.random.seed(2), list(
            m.BatchSampler(d(23), shuffle=True, batch_size=4)))[1]),
        ("batch_drop_last", lambda m, d: list(m.BatchSampler(
            d(23), batch_size=4, drop_last=True))),
        ("distributed", lambda m, d: [list(s) for s in [
            m.DistributedBatchSampler(d(23), 2, num_replicas=3, rank=1,
                                      shuffle=True)] for _ in range(3)]),
        ("distributed_epochs", lambda m, d: (lambda s: [list(s), list(s),
                                                        list(s)])(
            m.DistributedBatchSampler(d(23), 2, num_replicas=3, rank=2,
                                      shuffle=True, drop_last=True))),
    ]


@pytest.mark.parametrize("name,build", _sampler_pairs(),
                         ids=[n for n, _ in _sampler_pairs()])
def test_samplers_draw_the_jax_indices(name, build):
    port = build(tio, _Arange)
    ref = build(jio, _JArange)
    assert port == ref and len(port) > 0


def test_random_split_matches_jax():
    np.random.seed(4)
    port = tio.random_split(_Arange(10), [0.5, 0.3, 0.2])
    np.random.seed(4)
    ref = jio.random_split(_JArange(10), [0.5, 0.3, 0.2])
    assert [s.indices for s in port] == [s.indices for s in ref]
    assert sorted(sum((s.indices for s in port), [])) == list(range(10))


def test_distributed_sampler_defaults_to_one_replica_without_a_group():
    s = tio.DistributedBatchSampler(_Arange(10), 3)
    assert (s.nranks, s.local_rank) == (1, 0)
    assert list(s) == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9]]


# -- the DataLoader ---------------------------------------------------------------

def test_default_collate_matches_jax_types():
    samples = [_sample(i) for i in range(4)]
    port = tio.default_collate_fn(samples)
    ref = jio.default_collate_fn(samples)
    assert port[1].dtype == torch.int64 and port[2].dtype == torch.float32
    assert port[3]["name"] == ["s0", "s1", "s2", "s3"]
    assert port[3]["mask"].dtype == torch.bool
    assert isinstance(port, tuple) and isinstance(port[3]["pair"], tuple)
    _assert_same(port, ref)
    t = tio.default_collate_fn([torch.ones(2), torch.zeros(2)])
    assert t.shape == (2, 2)


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_equal_jax_nested(workers):
    port = list(tio.DataLoader(_Nested(), batch_size=3,
                               num_workers=workers))
    ref = list(jio.DataLoader(_JNested(), batch_size=3, num_workers=0))
    assert len(port) == len(ref) == 4
    for a, b in zip(port, ref):
        _assert_same(a, b)
    assert port[0][0].dtype == torch.float32
    assert port[0][3]["pair"][0].dtype == torch.int64


@pytest.mark.parametrize("workers", [0, 2])
def test_shuffled_loader_batches_equal_jax(workers):
    # workers draw their seed from numpy's global stream before the
    # sampler's permutation, in both packages
    np.random.seed(9)
    port = list(tio.DataLoader(_local(_Arange)(23), batch_size=4,
                               shuffle=True, num_workers=workers,
                               use_shared_memory=workers == 2))
    np.random.seed(9)
    ref = list(jio.DataLoader(_local(_JArange)(23), batch_size=4,
                              shuffle=True,
                              num_workers=workers,
                              use_shared_memory=False))
    assert len(port) == len(ref) == 6
    for a, b in zip(port, ref):
        assert a.dtype == torch.float64
        _assert_same(a, b)


@pytest.mark.parametrize("drop_last", [False, True])
def test_iterable_loader_matches_jax(drop_last):
    port = list(tio.DataLoader(_Stream(), batch_size=4, drop_last=drop_last,
                               num_workers=2))
    ref = list(jio.DataLoader(_JStream(), batch_size=4, drop_last=drop_last))
    assert len(port) == len(ref) == (2 if drop_last else 3)
    for a, b in zip(port, ref):
        _assert_same(a, b)
    with pytest.raises(TypeError):
        len(tio.DataLoader(_Stream()))


def test_loader_without_batching_and_batch_reader_match_jax():
    port = list(tio.DataLoader(_Nested(), batch_size=None))
    ref = list(jio.DataLoader(_JNested(), batch_size=None))
    assert len(port) == 10
    for a, b in zip(port, ref):
        _assert_same(a[0], b[0])

    def reader():
        yield from range(7)
    assert list(tbatch(reader, 3)()) == list(jbatch(reader, 3)())
    assert list(tbatch(reader, 3, drop_last=True)()) == [[0, 1, 2],
                                                                [3, 4, 5]]
    with pytest.raises(ValueError):
        tbatch(reader, 0)


def test_tensor_compose_concat_datasets():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    y = torch.arange(6)
    ds = tio.TensorDataset([x, y])
    assert isinstance(ds[2][0], torch.Tensor) and ds[2][1].item() == 2
    both = tio.ComposeDataset([ds, tio.TensorDataset([y * 10])])
    assert [t.item() for t in both[3][1:]] == [3, 30]
    cat = tio.ConcatDataset([_Arange(3), _Arange(4)])
    assert len(cat) == 7 and cat[4][0] == 1.0 and cat[-1][0] == 3.0
    # list() would ask for a len(), which an IterableDataset refuses
    chain = [x for x in tio.ChainDataset([_Stream(), _Stream()])]
    assert len(chain) == 22
    (xb, yb), = list(tio.DataLoader(ds, batch_size=6))
    assert torch.equal(xb, torch.from_numpy(x)) and torch.equal(yb, y)


# -- mid-epoch resume (the JAX package's tests/test_io_resume.py) -------------------

def _sampler(n=24, batch_size=2, module=tio, ds=_Arange):
    return module.DistributedBatchSampler(ds(n), batch_size=batch_size,
                                          num_replicas=1, rank=0,
                                          shuffle=True)


def _loader(n=24, batch_size=2, workers=0):
    return tio.DataLoader(_local(_Arange)(n),
                          batch_sampler=_sampler(n, batch_size),
                          num_workers=workers)


def _train(loader, w, total_batches):
    """A numpy 'training' in f64: the per-batch loss trajectory, ``w``
    updated in place (two runs over the same batches: the same bits)."""
    losses = []
    while len(losses) < total_batches:
        for batch in loader:
            g = batch.numpy().astype(np.float64).mean(axis=0)
            losses.append(float(np.dot(w, g)))
            w -= 0.01 * g
            if len(losses) >= total_batches:
                break
    return losses


@pytest.mark.parametrize("workers", [0, 2])
def test_resumed_loss_trajectory_is_bit_identical_to_oracle(workers):
    epochs, per_epoch = 3, len(_sampler())
    total = epochs * per_epoch
    oracle_w = np.zeros(3, np.float64)
    oracle = _train(_loader(), oracle_w, total)
    assert len(set(oracle)) > 1
    stop = per_epoch + 3
    w = np.zeros(3, np.float64)
    first = _loader(workers=workers)
    first_leg = _train(first, w, stop)
    state = first.state_dict()
    assert state == {"delivered": 3, "sampler": {"epoch": 1, "cursor": 3}}
    # the JAX loader reports the same state at the same point
    jl = jio.DataLoader(_JArange(24), batch_sampler=_sampler(
        module=jio, ds=_JArange))
    seen = 0
    while seen < stop:
        for _ in jl:
            seen += 1
            if seen >= stop:
                break
    assert jl.state_dict() == state
    resumed = _loader(workers=workers)
    resumed.load_state_dict(state)
    second_leg = _train(resumed, w, total - stop)
    assert first_leg + second_leg == oracle
    np.testing.assert_array_equal(w, oracle_w)


def test_resume_at_exact_epoch_boundary_rolls_over():
    per_epoch = len(_sampler())
    loader = _loader()
    w = np.zeros(3, np.float64)
    _train(loader, w, per_epoch)
    state = loader.state_dict()
    assert state["sampler"]["cursor"] == per_epoch
    oracle = _train(_loader(), np.zeros(3, np.float64), 2 * per_epoch)
    resumed = _loader()
    resumed.load_state_dict(state)
    assert _train(resumed, w, per_epoch) == oracle[per_epoch:]


def test_skipped_batches_fetch_no_data():
    fetched = []

    class Spy(_Arange):
        def __getitem__(self, i):
            fetched.append(i)
            return super().__getitem__(i)

    sampler = _sampler()
    loader = tio.DataLoader(Spy(), batch_sampler=sampler)
    loader.load_state_dict(
        {"delivered": 4, "sampler": {"epoch": 0, "cursor": 4}})
    batches = list(loader)
    assert len(batches) == len(sampler) - 4
    assert len(fetched) == 2 * len(batches)


def test_batch_sampler_state_roundtrip():
    bs = tio.BatchSampler(_Arange(10), batch_size=2)
    it = iter(bs)
    assert [next(it), next(it)] == [[0, 1], [2, 3]]
    assert bs.state_dict() == {"cursor": 2}
    bs2 = tio.BatchSampler(_Arange(10), batch_size=2)
    bs2.load_state_dict(bs.state_dict())
    assert list(bs2) == [[4, 5], [6, 7], [8, 9]]
    bs3 = tio.BatchSampler(_Arange(10), batch_size=2)
    bs3.load_state_dict({"cursor": 5})
    assert list(bs3) == [[0, 1], [2, 3], [4, 5], [6, 7], [8, 9]]
    a, b = _sampler(), _sampler()
    assert list(a) == list(b)
    b.set_epoch(5)
    epoch5 = list(b)
    assert epoch5 != list(a)
    b.set_epoch(5)
    assert list(b) == epoch5


@pytest.mark.skipif(os.name != "posix", reason="SIGKILLs a real worker")
def test_sigkilled_worker_raises_naming_worker_and_batch():
    class Slow(_Arange):       # defined here: unpicklable, so forked
        def __getitem__(self, i):
            time.sleep(0.05)
            return super().__getitem__(i)

    before = set(multiprocessing.active_children())
    loader = tio.DataLoader(Slow(64), batch_size=2, num_workers=2,
                            use_shared_memory=False, timeout=60)
    it = iter(loader)
    next(it)
    workers = [p for p in multiprocessing.active_children()
               if p not in before]
    assert len(workers) == 2
    victim = workers[0]
    os.kill(victim.pid, signal.SIGKILL)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as ei:
        for _ in it:
            pass
    msg = str(ei.value)
    assert "exited unexpectedly" in msg
    assert f"pid {victim.pid}" in msg
    assert "last dispatched batch index" in msg
    assert time.monotonic() - t0 < 30
    time.sleep(0.5)
    assert not [p for p in multiprocessing.active_children()
                if p not in before]


def test_worker_error_is_reraised_with_its_traceback():
    class Boom(tio.Dataset):
        def __getitem__(self, i):
            if i == 5:
                raise ValueError("sample 5 is poisoned")
            return np.zeros(2)

        def __len__(self):
            return 12

    with pytest.raises(RuntimeError) as ei:
        list(tio.DataLoader(Boom(), batch_size=2, num_workers=2))
    assert "DataLoader worker failed" in str(ei.value)
    assert "sample 5 is poisoned" in str(ei.value)
    assert "Traceback" in str(ei.value)
    with pytest.raises(RuntimeError, match="sample 5 is poisoned"):
        list(tio.DataLoader(Boom(), batch_size=2))


def test_workers_fetch_at_most_the_prefetch_window_ahead():
    """Batches are sent to the workers at most ``prefetch_factor *
    num_workers`` ahead of the consumer, however long it takes."""
    fetched = multiprocessing.Value("i", 0)

    class Count(_Arange):      # forked: the workers share the counter
        def __getitem__(self, i):
            with fetched.get_lock():
                fetched.value += 1
            return super().__getitem__(i)

    loader = tio.DataLoader(Count(64), batch_size=2, num_workers=2,
                            prefetch_factor=2)
    it = iter(loader)
    next(it)
    time.sleep(1.0)
    assert fetched.value == 2 * (1 + 2 * 2)
    rest = list(it)
    assert len(rest) == 31 and fetched.value == 64


def test_early_stop_leaves_no_worker_and_no_segment():
    """Shared-memory batches left in flight when the consumer stops: the
    workers are joined and nothing of theirs stays in /dev/shm."""
    before = set(multiprocessing.active_children())
    shm = set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()
    loader = tio.DataLoader(_local(_Arange)(64, dim=4096), batch_size=4,
                            num_workers=2, prefetch_factor=4)
    it = iter(loader)
    first = next(it)
    pids = [p.pid for p in multiprocessing.active_children()
            if p not in before]
    assert len(pids) == 2 and first.shape == (4, 4096)
    it.close()
    assert not [p for p in multiprocessing.active_children()
                if p not in before]
    if os.path.isdir("/dev/shm"):
        left = [n for n in set(os.listdir("/dev/shm")) - shm
                if any(str(pid) in n for pid in pids)]
        assert left == []


# -- save / load --------------------------------------------------------------------

def _state(rng):
    return {"w": rng.randn(4, 3).astype(np.float32),
            "b": rng.randn(3).astype(np.float32),
            "step": np.int64(7)}


def test_save_load_f32_crosses_both_ways(tmp_path):
    rng = np.random.RandomState(0)
    arrays = _state(rng)
    jstate = {"w": pt.to_tensor(arrays["w"]), "b": pt.to_tensor(arrays["b"]),
              "step": 7, "nested": [pt.to_tensor(arrays["b"]), "x"]}
    jio_state.save(jstate, str(tmp_path / "j.pdparams"))
    got = io_state.load(str(tmp_path / "j.pdparams"))
    assert isinstance(got["w"], torch.Tensor) and got["w"].dtype == \
        torch.float32
    np.testing.assert_array_equal(got["w"].numpy(), arrays["w"])
    np.testing.assert_array_equal(got["nested"][0].numpy(), arrays["b"])
    assert got["step"] == 7 and got["nested"][1] == "x"

    tstate = {"w": torch.from_numpy(arrays["w"]),
              "b": torch.nn.Parameter(torch.from_numpy(arrays["b"])),
              "step": 7}
    io_state.save(tstate, str(tmp_path / "sub" / "t.pdparams"))
    back = jio_state.load(str(tmp_path / "sub" / "t.pdparams"))
    np.testing.assert_array_equal(np.asarray(back["w"]._data), arrays["w"])
    np.testing.assert_array_equal(np.asarray(back["b"]._data), arrays["b"])
    assert back["step"] == 7
    raw = io_state.load(str(tmp_path / "sub" / "t.pdparams"),
                        return_numpy=True)
    assert isinstance(raw["w"], np.ndarray)
    with open(tmp_path / "sub" / "t.pdparams", "rb") as f:
        leaf = pickle.load(f)["b"]
    assert leaf["__tensor__"] and leaf["name"] == "b"
    assert leaf["stop_gradient"] is False


def test_save_load_bf16_port_to_port_and_the_cross_package_hazard(tmp_path):
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    io_state.save({"x": x}, str(tmp_path / "t.pdparams"))
    got = io_state.load(str(tmp_path / "t.pdparams"))["x"]
    assert got.dtype == torch.bfloat16 and torch.equal(got.view(torch.int16),
                                                       x.view(torch.int16))
    np.testing.assert_array_equal(
        io_state.load(str(tmp_path / "t.pdparams"), return_numpy=True)["x"],
        x.float().numpy())
    # the JAX package reads the port's bf16 leaf as its uint16 bits
    j = jio_state.load(str(tmp_path / "t.pdparams"))["x"]
    assert np.asarray(j._data).dtype == np.uint16
    # the JAX package's bf16 (ml_dtypes arrays) reads in the port here
    jio_state.save({"x": pt.to_tensor(x.float().numpy()).astype("bfloat16")},
                   str(tmp_path / "j.pdparams"))
    from_jax = io_state.load(str(tmp_path / "j.pdparams"))["x"]
    assert from_jax.dtype == torch.bfloat16 and torch.equal(
        from_jax.view(torch.int16), x.view(torch.int16))


class _Evil:
    def __reduce__(self):
        return (os.getcwd, ())


class _EvilNumpy:
    """A reference to a numpy function that runs ``exec`` on a string:
    a module name that starts with ``numpy`` is not enough to load."""
    def __reduce__(self):
        from numpy.testing._private.utils import runstring
        return (runstring, ("raise SystemExit('ran')", {}))


def test_load_refuses_other_classes(tmp_path):
    path = tmp_path / "evil.pdparams"
    with open(path, "wb") as f:
        pickle.dump({"x": _Evil()}, f)
    with pytest.raises(pickle.UnpicklingError, match="refuses"):
        io_state.load(str(path))
    with open(path, "wb") as f:
        pickle.dump({"t": torch.ones(2)}, f)
    with pytest.raises(pickle.UnpicklingError, match="refuses"):
        io_state.load(str(path))
    with open(path, "wb") as f:
        pickle.dump({"x": _EvilNumpy()}, f)
    with pytest.raises(pickle.UnpicklingError,
                       match="refuses.*numpy.testing._private.utils"):
        io_state.load(str(path))


@pytest.mark.parametrize("protocol", [3, 4, 5])
def test_save_load_round_trip_in_each_pickle_protocol(tmp_path, protocol):
    """Every protocol from 3 loads under the exact allowlist (5 pickles
    a contiguous array through numpy's ``_frombuffer``), numpy scalars,
    dtypes, an ``OrderedDict`` and a strided array included."""
    rng = np.random.RandomState(protocol)
    state = collections.OrderedDict(
        w=torch.from_numpy(rng.randn(4, 3).astype(np.float32)),
        ids=torch.arange(5), mask=torch.tensor([True, False]),
        t=torch.from_numpy(rng.randn(3, 4).astype(np.float32)).T,
        scale=np.float32(0.5), kind=np.dtype("int8"), step=7)
    path = str(tmp_path / "s.pdparams")
    io_state.save(state, path, protocol=protocol)
    got = io_state.load(path)
    assert list(got) == list(state)
    for k in ("w", "ids", "mask", "t"):
        assert got[k].dtype == state[k].dtype
        assert torch.equal(got[k], state[k])
    assert got["scale"] == np.float32(0.5) and got["kind"] == np.int8
    assert got["step"] == 7


# -- metrics ---------------------------------------------------------------------------

def _preds(n=50, c=6, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, c).astype(np.float32),
            rng.randint(0, c, (n, 1)).astype(np.int64))


@pytest.mark.parametrize("topk", [1, (1, 3)])
def test_accuracy_matches_jax(topk):
    port, ref = tmetric.Accuracy(topk=topk), jmetric.Accuracy(topk=topk)
    assert port.name() == ref.name()
    for seed in range(3):
        pred, label = _preds(seed=seed)
        a = port.update(port.compute(torch.from_numpy(pred),
                                     torch.from_numpy(label)))
        b = ref.update(ref.compute(pt.to_tensor(pred), pt.to_tensor(label)))
        assert np.all(np.asarray(a) == np.asarray(b))
    assert np.all(np.asarray(port.accumulate()) ==
                  np.asarray(ref.accumulate()))
    port.reset()
    assert port.count == 0


def test_functional_accuracy_and_one_hot_labels_match_jax():
    pred, label = _preds(seed=4)
    for k in (1, 2):
        a = tmetric.accuracy(torch.from_numpy(pred), torch.from_numpy(label),
                             k=k)
        b = jmetric.accuracy(pt.to_tensor(pred), pt.to_tensor(label), k=k)
        # XLA divides the f32 sum by the count as a product with its
        # reciprocal: within one f32 ulp of the quotient
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.item(), float(b._data), rtol=2 ** -23,
                                   atol=0)
    one_hot = np.eye(6, dtype=np.float32)[label[:, 0]]
    port, ref = tmetric.Accuracy(), jmetric.Accuracy()
    a = port.update(port.compute(pred, one_hot))
    b = ref.update(ref.compute(pred, one_hot))
    assert a == b


@pytest.mark.parametrize("cls", ["Precision", "Recall", "Auc"])
def test_binary_metrics_match_jax(cls):
    port, ref = getattr(tmetric, cls)(), getattr(jmetric, cls)()
    assert port.accumulate() == ref.accumulate() == 0.0
    rng = np.random.RandomState(3)
    for _ in range(3):
        p = rng.rand(40, 2 if cls == "Auc" else 1).astype(np.float32)
        lab = rng.randint(0, 2, (40, 1)).astype(np.int64)
        port.update(torch.from_numpy(p), torch.from_numpy(lab))
        ref.update(pt.to_tensor(p), pt.to_tensor(lab))
    assert port.accumulate() == ref.accumulate()
    assert port.name() == ref.name()
