"""The port's crash-consistent checkpoint (``paddle_tpu_torch.distributed``)
on the CPU, against the JAX package's.

 - the retry primitives, and the port's counterparts of the JAX
   package's crash-consistency, integrity, reshard, janitor and manager
   tests (``tests/test_checkpoint_crash_consistency.py``,
   ``test_checkpoint_reshard.py``), faults injected through the port's
   own ``_write_file`` / ``_replace_dir`` seam;
 - cross-package round trips: one tree with f32, bf16, int32 0-d, int8
   and uint8 leaves, saved by either package, loads in the other with
   the same bits and passes the other's ``verify_checkpoint``; both
   write byte-identical ``data/**.npy`` and ``index.0.json``;
 - resume: on gpt_tiny (f32, dropout 0.1, AdamW under LinearWarmup over
   CosineAnnealingDecay, a global-norm clip), 2N uninterrupted steps give
   the same bits as N, a save, a fresh step from another seed restored,
   and N more (and as N more on the same step restored); at dropout 0,
   JAX N steps -> save -> port M steps, and the reverse, against the
   other package continuing: losses within 1e-5 (``test_torch_train``'s
   harness and tolerance), parameters within ``2 * lr``, its bound for
   AdamW's first steps;
 - the schedule's state through the manager's ``data_state``: the JAX
   scheduler loads the port's and the next rates are equal.
"""
import gc
import json
import os
import random
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as pt
from paddle_tpu.core import TCPStore
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.distributed.checkpoint_manager import \
    CheckpointManager as JCheckpointManager
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.distributed.checkpoint import (
    CheckpointCorruptError, HostLocalShard, ReshardError, is_committed,
    load_sharded, load_state, read_leaf, save_sharded, store_barrier,
    sweep_staging, verify_checkpoint)
from paddle_tpu_torch.distributed.checkpoint_manager import (
    CheckpointManager, latest_checkpoint)
from paddle_tpu_torch.framework.random import (make_generator,
                                               restore_generator_state)
from paddle_tpu_torch.incubate.models import (GPTPretrainingCriterion,
                                              gpt_tiny)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import SGD, AdamW, lr
from paddle_tpu_torch.train import (TrainStep, build_train_step, make_batch,
                                    restore_checkpoint, save_checkpoint)
from paddle_tpu_torch.utils.retry import backoff_delays, retry_call, wait_until

from fault_injection import (corrupt_file, data_files, poison_shard,
                             truncate_file)
from test_torch_train import LR, _Jax, _batch, _port, _t


class KilledSave(BaseException):
    """The injected "process died here" (a BaseException, as a SIGKILL
    cannot be caught by ``except Exception``)."""


class FaultInjector:
    """Kill a port save after ``fail_after`` durable writes (the killing
    write first lands ``partial_bytes`` of its payload when given), or
    between a complete staging dir and its rename
    (``fail_before_rename``), by patching the port's seam."""

    def __init__(self, fail_after=0, partial_bytes=None,
                 fail_before_rename=False):
        self.fail_after = fail_after
        self.partial_bytes = partial_bytes
        self.fail_before_rename = fail_before_rename
        self.writes = 0

    def __enter__(self):
        self._write, self._replace = ckpt._write_file, ckpt._replace_dir

        def write(path, data, durable=True):
            if self.fail_after is not None and self.writes >= self.fail_after:
                if self.partial_bytes is not None:
                    self._write(path, data[:self.partial_bytes], durable)
                raise KilledSave(f"killed at write #{self.writes + 1}")
            self.writes += 1
            return self._write(path, data, durable)

        def replace(tmp, final):
            if self.fail_before_rename:
                raise KilledSave(f"killed before renaming {tmp}")
            return self._replace(tmp, final)

        ckpt._write_file, ckpt._replace_dir = write, replace
        return self

    def __exit__(self, *exc):
        ckpt._write_file, ckpt._replace_dir = self._write, self._replace
        return False


def _state(v):
    """A small tree, distinct per version ``v``."""
    return {"w": torch.arange(32, dtype=torch.float32).reshape(8, 4) + v,
            "nested": {"b": torch.full((6,), float(v))}}


def _assert_state_equal(a, b):
    fa, fb = dict(ckpt._flat_items(a)), dict(ckpt._flat_items(b))
    assert list(fa) == list(fb)
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


def _count_writes(tmp_path, state):
    with FaultInjector(fail_after=10 ** 6) as fi:
        save_sharded(state, str(tmp_path / "_probe"))
    return fi.writes


# -- retry primitives ----------------------------------------------------------

class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, d):
        assert d >= 0
        self.t += d


def test_backoff_delays_shape_cap_jitter_and_deadline():
    assert list(backoff_delays(base=0.1, factor=2.0, max_delay=0.5,
                               jitter=0.0, max_tries=5)) == \
        [0.1, 0.2, 0.4, 0.5, 0.5]
    ds = list(backoff_delays(base=1.0, factor=1.0, max_delay=1.0,
                             jitter=0.25, max_tries=100,
                             rng=random.Random(0)))
    assert all(0.75 <= d <= 1.25 for d in ds) and len(set(ds)) > 1
    clk = _FakeClock()
    out = []
    for d in backoff_delays(base=1.0, factor=1.0, max_delay=1.0, jitter=0.0,
                            deadline=2.5, clock=clk):
        out.append(d)
        clk.sleep(d)
    assert out == [1.0, 1.0, 0.5] and clk.t == 2.5
    for bad in (dict(base=-1), dict(factor=0.5), dict(jitter=2.0)):
        with pytest.raises(ValueError):
            next(backoff_delays(**bad))


def test_retry_call_and_wait_until():
    clk = _FakeClock()
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise ConnectionError("store not up yet")
        return "ok"

    seen = []
    assert retry_call(flaky, retry_on=(ConnectionError,), deadline=60,
                      base=0.05, jitter=0.0, sleep=clk.sleep, clock=clk,
                      on_retry=lambda a, e, d: seen.append((a, d))) == "ok"
    assert seen == [(1, 0.05), (2, 0.1)]

    def boom():
        raise ValueError("not retryable")
    with pytest.raises(ValueError):
        retry_call(boom, retry_on=(ConnectionError,), max_tries=10,
                   sleep=lambda d: None)
    vals = iter([None, 0, "", (1, 2)])
    assert wait_until(lambda: next(vals), timeout=60, jitter=0.0,
                      sleep=clk.sleep, clock=clk) == (1, 2)
    clk = _FakeClock()
    with pytest.raises(TimeoutError, match="peer rendezvous"):
        wait_until(lambda: False, timeout=1.0, jitter=0.0,
                   desc="peer rendezvous", sleep=clk.sleep, clock=clk)
    assert clk.t <= 1.0


# -- atomic commit: a kill at every write ---------------------------------------

def test_kill_after_any_write_falls_back_to_previous_commit(tmp_path):
    v1, v2 = _state(1), _state(2)
    total = _count_writes(tmp_path, v1)
    assert total >= 4  # 2 shards + index + COMMIT marker
    for n in range(total):
        mgr = CheckpointManager(str(tmp_path / f"root_{n}"), keep_last_n=3)
        mgr.save(1, v1)
        with pytest.raises(KilledSave):
            with FaultInjector(fail_after=n):
                mgr.save(2, v2)
        assert mgr.latest_step() == 1
        restored, step = mgr.restore_latest(template=_state(0))
        assert step == 1
        _assert_state_equal(restored, v1)
        mgr.save(2, v2)
        restored, step = mgr.restore_latest(template=_state(0))
        assert step == 2
        _assert_state_equal(restored, v2)


def test_kill_before_rename_torn_write_and_overwrite(tmp_path):
    root = str(tmp_path / "root")
    mgr = CheckpointManager(root)
    mgr.save(1, _state(1))
    with pytest.raises(KilledSave):
        with FaultInjector(fail_after=None, fail_before_rename=True):
            mgr.save(2, _state(2))
    assert not os.path.isdir(mgr.step_dir(2))
    assert mgr.latest_step() == 1
    assert any(".tmp." in n for n in os.listdir(root))
    with pytest.raises(KilledSave):
        with FaultInjector(fail_after=1, partial_bytes=7):
            mgr.save(2, _state(2))
    assert mgr.latest_step() == 1
    # a re-save of an existing step killed midway keeps the old content
    with pytest.raises(KilledSave):
        with FaultInjector(fail_after=2):
            mgr.save(1, _state(9))
    restored, step = mgr.restore_latest(template=_state(0))
    assert step == 1
    _assert_state_equal(restored, _state(1))
    mgr.save(3, _state(3))
    assert not any(".tmp." in n for n in os.listdir(root))


# -- integrity: corruption after the commit ---------------------------------------

def test_corrupted_shard_detected_named_and_skipped(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "root"))
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    d2 = mgr.step_dir(2)
    victim = data_files(d2)[0]
    corrupt_file(os.path.join(d2, victim))
    with pytest.raises(CheckpointCorruptError, match="CRC"):
        load_sharded(d2, template=_state(0))
    with pytest.raises(CheckpointCorruptError,
                       match=victim.replace("\\", "/").split("/")[-2]):
        verify_checkpoint(d2, integrity="full")
    assert mgr.latest_step() == 2          # the size scan cannot see it
    restored, step = mgr.restore_latest(template=_state(0))
    assert step == 1
    _assert_state_equal(restored, _state(1))
    assert mgr.latest_step() == 1


def test_poisoned_shard_caught_only_by_the_content_digest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "root"))
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    rel = poison_shard(mgr.step_dir(2))
    verify_checkpoint(mgr.step_dir(2), integrity="size")
    with pytest.raises(CheckpointCorruptError, match="content digest") as ei:
        verify_checkpoint(mgr.step_dir(2), integrity="full")
    assert "'nested.b'" in str(ei.value) and "nested.b" in rel
    restored, step = mgr.restore_latest(template=_state(0))
    assert step == 1
    _assert_state_equal(restored, _state(1))


def test_truncated_missing_unreadable_uncommitted(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "root"))
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    truncate_file(os.path.join(mgr.step_dir(2), data_files(mgr.step_dir(2))[0]))
    assert mgr.latest_step() == 1          # the size scan rejects step 2
    p = str(tmp_path / "ck")
    save_sharded(_state(1), p)
    os.remove(os.path.join(p, data_files(p)[0]))
    with pytest.raises(CheckpointCorruptError, match="missing"):
        verify_checkpoint(p, integrity="size")
    save_sharded(_state(1), p)
    with open(os.path.join(p, "COMMIT.0"), "w") as f:
        f.write("{not json")
    assert not is_committed(p)
    with pytest.raises(CheckpointCorruptError):
        verify_checkpoint(p)
    save_sharded(_state(1), p)
    os.remove(os.path.join(p, "COMMIT.0"))
    with pytest.raises(CheckpointCorruptError, match="COMMIT"):
        load_sharded(p, template=_state(0))
    save_sharded(_state(3), p)
    _assert_state_equal(load_sharded(p, template=_state(0),
                                     integrity="off"), _state(3))


def test_multihost_commit_requires_all_markers(tmp_path):
    p = str(tmp_path / "ck")
    v = _state(4)
    save_sharded(v, p, process_index=0, world_size=2)
    assert not is_committed(p)
    with pytest.raises(CheckpointCorruptError, match="1"):
        verify_checkpoint(p, integrity="size")
    save_sharded(v, p, process_index=1, world_size=2)
    assert is_committed(p)
    verify_checkpoint(p, integrity="full")
    marker = json.load(open(os.path.join(p, "COMMIT.1")))
    assert marker["world"] == 2 and marker["proc"] == 1


class _DictStore:
    """The store protocol over a dict: ``set``, ``get`` (None for an
    absent key unless ``wait``), ``add``; thread safe."""

    def __init__(self):
        self.d, self.cv = {}, threading.Condition()

    def set(self, key, value):
        with self.cv:
            self.d[key] = value if isinstance(value, bytes) else \
                str(value).encode()
            self.cv.notify_all()

    def get(self, key, wait=True, timeout=30.0):
        with self.cv:
            if wait:
                self.cv.wait_for(lambda: key in self.d, timeout)
            return self.d.get(key)

    def add(self, key, n):
        with self.cv:
            v = int(self.d.get(key, b"0")) + n
            self.d[key] = str(v).encode()
            self.cv.notify_all()
            return v


def test_store_barrier_counts_names_and_times_out():
    s = _DictStore()
    store_barrier(s, "ckpt/x/commit", 1)
    s.add("ckpt/y/commit", 1)
    store_barrier(s, "ckpt/y/commit", 2)
    with pytest.raises(TimeoutError):
        store_barrier(_DictStore(), "ckpt/z/commit", 2, timeout=0.2)
    with pytest.raises(TimeoutError) as ei:
        store_barrier(_DictStore(), "b/x", world=3, rank=0, timeout=0.4)
    assert "missing ranks [1, 2]" in str(ei.value)
    assert "arrived: [0]" in str(ei.value)


@pytest.mark.parametrize("store", ["dict", "tcp"])
def test_staged_commit_two_ranks_threads(tmp_path, store):
    """Both ranks stage into one shared dir, barrier, rank 0 promotes:
    over the protocol's dict store and over the JAX package's TCPStore."""
    w, bias = _global_state()
    root = str(tmp_path / "run")
    master = TCPStore("127.0.0.1", 0, is_master=True) if store == "tcp" \
        else _DictStore()
    errs = []

    def one_rank(rank):
        try:
            s = TCPStore("127.0.0.1", master.port, is_master=False) \
                if store == "tcp" else master
            mgr = CheckpointManager(root, keep_last_n=None, store=s,
                                    world_size=2, process_index=rank,
                                    durable=False, run_id="t-port",
                                    barrier_timeout=30.0)
            lo, hi = rank * ROWS // 2, (rank + 1) * ROWS // 2
            mgr.save(7, {"w": HostLocalShard(
                w[lo:hi], window=[[lo, hi], [0, COLS]],
                global_shape=(ROWS, COLS))})
        except BaseException as e:  # pragma: no cover - failure path
            errs.append((rank, e))

    ts = [threading.Thread(target=one_rank, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    if store == "tcp":
        master.close()
    assert not errs, errs
    step = os.path.join(root, "step_00000007")
    verify_checkpoint(step, integrity="full")
    assert read_leaf(step, "w").tobytes() == w.tobytes()
    assert not [n for n in os.listdir(root) if ".tmp." in n]
    assert json.load(open(os.path.join(step, "COMMIT.0"))).get("nonce")


# -- the manager: rotation, GC, async -------------------------------------------

def test_gc_keeps_last_n_and_never_the_only_valid(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "a"), keep_last_n=2)
    for i in range(1, 5):
        mgr.save(i, _state(i))
    assert mgr.all_steps() == [3, 4] and mgr.valid_steps() == [3, 4]
    mgr = CheckpointManager(str(tmp_path / "b"), keep_last_n=1)
    mgr.save(1, _state(1))
    for n in (0, 1, 2):
        with pytest.raises(KilledSave):
            with FaultInjector(fail_after=n):
                mgr.save(2, _state(2))
        assert mgr.latest_step() == 1
    mgr.save(3, _state(3))
    assert mgr.all_steps() == [3]
    root = str(tmp_path / "c")
    mgr = CheckpointManager(root, keep_last_n=2)
    mgr.save(1, _state(1))
    os.makedirs(os.path.join(root, "step_00000000"))
    os.makedirs(os.path.join(root, "step_00000099"))
    mgr.save(2, _state(2))
    names = set(os.listdir(root))
    assert "step_00000000" not in names and "step_00000099" in names
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path / "d"), keep_last_n=0)
    tpl = _state(0)
    state, step = CheckpointManager(str(tmp_path / "e")).restore_latest(
        template=tpl)
    assert step is None and state is tpl


def test_async_save_round_trip_error_and_block(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "root"), async_save=True,
                            keep_last_n=2)
    live = _state(1)
    mgr.save(1, live)
    live["w"].add_(100)          # the host copy was taken before return
    mgr.save(2, _state(2))
    mgr.save(3, _state(3))
    mgr.close()
    assert mgr.all_steps() == [2, 3]
    mgr = CheckpointManager(str(tmp_path / "r2"), async_save=True)
    mgr.save(1, live)
    mgr.wait()
    restored, _ = mgr.restore_latest(template=_state(0))
    _assert_state_equal(restored, live)
    with FaultInjector(fail_after=0):
        mgr.save(2, _state(2))
        with pytest.raises(KilledSave):
            mgr.wait()
    assert mgr.latest_step() == 1
    mgr.save(3, _state(3), block=True)
    assert is_committed(mgr.step_dir(3))


def test_latest_checkpoint_and_data_state(tmp_path):
    root = str(tmp_path / "root")
    assert latest_checkpoint(root) is None
    mgr = CheckpointManager(root)
    assert latest_checkpoint(root) is None
    mgr.save(7, _state(7), data_state={"epoch": 2, "cursor": [1, 2]})
    assert latest_checkpoint(root) == mgr.step_dir(7)
    assert mgr.load_data_state() == {"epoch": 2, "cursor": [1, 2]}
    p = str(tmp_path / "plain")
    save_sharded(_state(1), p)
    assert latest_checkpoint(p) is None


# -- resharding across world sizes -----------------------------------------------

ROWS, COLS = 12, 4


def _global_state(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(ROWS, COLS).astype(np.float32),
            rng.randn(COLS).astype(np.float32))


def _save_world(path, world, w, bias):
    for rank in range(world):
        lo, hi = rank * ROWS // world, (rank + 1) * ROWS // world
        save_sharded({"w": HostLocalShard(w[lo:hi],
                                          window=[[lo, hi], [0, COLS]],
                                          global_shape=(ROWS, COLS)),
                      "bias": HostLocalShard(bias)},
                     path, process_index=rank, world_size=world,
                     durable=False)


def test_hostlocalshard_validates_window():
    with pytest.raises(ValueError, match="window rank"):
        HostLocalShard(np.zeros((2, 3)), window=[[0, 2]], global_shape=(4, 3))
    with pytest.raises(ValueError, match="out of bounds"):
        HostLocalShard(np.zeros((2, 3)), window=[[3, 5], [0, 3]],
                       global_shape=(4, 3))
    with pytest.raises(ValueError, match="does not fill"):
        HostLocalShard(np.zeros((2, 3)), window=[[0, 3], [0, 3]],
                       global_shape=(4, 3))


@pytest.mark.parametrize("m,n", [(2, 1), (1, 2), (3, 2), (2, 3)])
def test_reshard_roundtrip_across_world_sizes(tmp_path, m, n):
    w, bias = _global_state()
    path = str(tmp_path / "step")
    _save_world(path, m, w, bias)
    verify_checkpoint(path, integrity="full")
    jckpt.verify_checkpoint(path, integrity="full")
    for rank in range(n):
        lo, hi = rank * ROWS // n, (rank + 1) * ROWS // n
        got = read_leaf(path, "w", window=[[lo, hi], [0, COLS]])
        assert got.tobytes() == w[lo:hi].tobytes()
        assert jckpt.read_leaf(path, "w", window=[[lo, hi], [0, COLS]]
                               ).tobytes() == w[lo:hi].tobytes()
    out = load_sharded(path, elastic=True)
    assert out["w"].numpy().tobytes() == w.tobytes()
    assert out["bias"].numpy().tobytes() == bias.tobytes()


def test_elastic_overlap_gap_mismatch_and_uncommitted(tmp_path):
    w, bias = _global_state()
    path = str(tmp_path / "a")
    _save_world(path, 3, w, bias)
    os.remove(os.path.join(path, "COMMIT.1"))
    os.remove(os.path.join(path, "COMMIT.2"))
    assert read_leaf(path, "bias", elastic=True).tobytes() == bias.tobytes()
    path = str(tmp_path / "b")
    _save_world(path, 3, w, bias)
    os.remove(os.path.join(path, "COMMIT.1"))
    with pytest.raises(ReshardError, match=r"committed ranks \[0, 2\]"):
        read_leaf(path, "w", elastic=True)
    with pytest.raises(ReshardError):
        load_sharded(path, elastic=True)
    assert issubclass(ReshardError, CheckpointCorruptError)
    path = str(tmp_path / "c")
    _save_world(path, 2, w, bias)
    os.remove(os.path.join(path, "COMMIT.1"))
    with pytest.raises(CheckpointCorruptError) as ei:
        load_sharded(path)
    msg = str(ei.value)
    assert "ranks [0]" in msg and "expects ranks [0, 1]" in msg
    assert "missing ranks [1]" in msg and "elastic=True" in msg
    for f in os.listdir(os.path.join(path, "data", "w")):
        if f.startswith("1_"):
            with open(os.path.join(path, "data", "w", f), "wb") as fh:
                fh.write(b"garbage")
    with pytest.raises(ReshardError):
        read_leaf(path, "w", elastic=True)


def test_janitor_and_manager_elastic_fallback(tmp_path):
    root = str(tmp_path / "j")
    w, bias = _global_state()
    _save_world(os.path.join(root, "step_00000001"), 1, w, bias)
    old = time.time() - 7200
    for name, aged in [("step_00000002.tmp.aaaa", True),
                       ("step_00000002.old.bbbb", True),
                       ("step_00000003.tmp.cccc", False)]:
        os.makedirs(os.path.join(root, name, "data"))
        if aged:
            os.utime(os.path.join(root, name), (old, old))
    os.makedirs(os.path.join(root, "notes"))
    os.utime(os.path.join(root, "notes"), (old, old))
    assert sweep_staging(root, max_age=3600.0) == 2
    assert sorted(os.listdir(root)) == ["notes", "step_00000001",
                                        "step_00000003.tmp.cccc"]
    partial = os.path.join(root, "step_00000004")
    save_sharded({"w": HostLocalShard(w[:6], window=[[0, 6], [0, COLS]],
                                      global_shape=(ROWS, COLS))},
                 partial, process_index=0, world_size=2, durable=False)
    assert sweep_staging(root, max_age=3600.0) == 0   # fresh: left alone
    os.utime(partial, (old, old))
    assert sweep_staging(root, max_age=3600.0) == 1
    assert sweep_staging(str(tmp_path / "nope")) == 0
    run = str(tmp_path / "run")
    os.makedirs(run)
    w1, b1 = _global_state(1)
    w2, b2 = _global_state(2)
    _save_world(os.path.join(run, "step_00000001"), 1, w1, b1)
    _save_world(os.path.join(run, "step_00000002"), 2, w2, b2)
    os.remove(os.path.join(run, "step_00000002", "COMMIT.1"))
    mgr = CheckpointManager(run, keep_last_n=None, elastic=True,
                            orphan_age=None)
    assert mgr.valid_steps() == [1]
    state, step = mgr.restore_latest()
    assert step == 1 and state["w"].numpy().tobytes() == w1.tobytes()
    os.makedirs(os.path.join(run, "step_00000001.tmp.dddd", "data"))
    os.utime(os.path.join(run, "step_00000001.tmp.dddd"), (old, old))
    os.makedirs(os.path.join(run, "step_00000005.tmp.eeee", "data"))
    CheckpointManager(run, orphan_age=3600.0)
    assert not os.path.exists(os.path.join(run, "step_00000001.tmp.dddd"))
    assert os.path.exists(os.path.join(run, "step_00000005.tmp.eeee"))


# -- cross-package round trips ---------------------------------------------------

def _mixed_arrays():
    rng = np.random.RandomState(3)
    return {"w": rng.randn(8, 4).astype(np.float32),
            "layers.0.attn": {"b16": rng.randn(3, 5).astype(np.float32),
                              "q": rng.randint(-127, 128, (4, 6)
                                               ).astype(np.int8)},
            "step": np.asarray(5, np.int32),
            "u": rng.randint(0, 256, 16).astype(np.uint8)}


def _torch_tree(a):
    return {"w": torch.from_numpy(a["w"]),
            "layers.0.attn": {
                "b16": torch.from_numpy(a["layers.0.attn"]["b16"]).to(
                    torch.bfloat16),
                "q": torch.from_numpy(a["layers.0.attn"]["q"])},
            "step": torch.tensor(5, dtype=torch.int32),
            "u": torch.from_numpy(a["u"])}


def _jax_tree(a):
    return {"w": jnp.asarray(a["w"]),
            "layers.0.attn": {
                "b16": jnp.asarray(a["layers.0.attn"]["b16"]).astype(
                    jnp.bfloat16),
                "q": jnp.asarray(a["layers.0.attn"]["q"])},
            "step": jnp.asarray(5, jnp.int32),
            "u": jnp.asarray(a["u"])}


def _bits(x):
    """The bytes of a tensor's or a JAX array's elements."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def test_both_packages_write_the_same_bytes(tmp_path):
    a = _mixed_arrays()
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    save_sharded(_torch_tree(a), port)
    jckpt.save_sharded(_jax_tree(a), ref)
    assert data_files(port) == data_files(ref)
    assert len(data_files(port)) == 5
    for rel in data_files(port) + ["index.0.json"]:
        with open(os.path.join(port, rel), "rb") as f, \
                open(os.path.join(ref, rel), "rb") as g:
            assert f.read() == g.read(), rel
    index = json.load(open(os.path.join(port, "index.0.json")))
    assert {e["dtype"] for e in index.values()} == {
        "float32", "bfloat16", "int32", "int8", "uint8"}


def test_port_checkpoint_loads_in_jax_with_the_same_bits(tmp_path):
    """Every leaf but bf16 through the JAX loader; bf16 through numpy.

    Pinned: the JAX package's loader cannot read a bf16 leaf back at all
    here, its own no more than the port's (assigning the ``'<V2'``
    array to an ``ml_dtypes.bfloat16`` one raises "No cast function
    available" with numpy 2 and ml_dtypes 0.5), so the bf16 leaf is read
    as the JAX package's files would be read, ``np.load`` viewed as
    ``ml_dtypes.bfloat16``: the same bits, and the file is byte for
    byte the JAX package's own (the test above)."""
    import ml_dtypes
    a = _mixed_arrays()
    tree = _torch_tree(a)
    path, ref = str(tmp_path / "ck"), str(tmp_path / "jax")
    save_sharded(tree, path)
    jckpt.verify_checkpoint(path, integrity="full")
    zeros = _jax_tree({k: (np.zeros_like(v) if not isinstance(v, dict) else
                           {kk: np.zeros_like(vv) for kk, vv in v.items()})
                       for k, v in a.items()})
    del zeros["layers.0.attn"]["b16"]
    got = jckpt.load_sharded(path, template=zeros)
    want, have = dict(ckpt._flat_items(tree)), dict(ckpt._flat_items(got))
    b16 = ("layers.0.attn", "b16")
    assert sorted(have) == sorted(k for k in want if k != b16)
    for k in have:
        assert str(have[k].dtype) == ckpt._dtype_name(want[k]), k
        assert _bits(have[k]) == _bits(want[k]), k
    jckpt.save_sharded(_jax_tree(a), ref)
    for where in (path, ref):
        with pytest.raises(ValueError, match="No cast function"):
            jckpt.read_leaf(where, "layers\\u002e0\\u002eattn.b16")
    f = os.path.join(path, "data", "layers_u002e0_u002eattn.b16", "0_0.npy")
    on_disk = np.load(f).view(ml_dtypes.bfloat16)
    assert on_disk.tobytes() == _bits(want[b16])
    assert np.array_equal(on_disk.astype(np.float32),
                          want[b16].float().numpy())


def test_jax_checkpoint_loads_in_the_port_with_the_same_bits(tmp_path):
    a = _mixed_arrays()
    tree = _jax_tree(a)
    path = str(tmp_path / "ck")
    jckpt.save_sharded(tree, path)
    verify_checkpoint(path, integrity="full")
    got = load_sharded(path)
    want, have = dict(ckpt._flat_items(tree)), dict(ckpt._flat_items(got))
    assert sorted(want) == sorted(have)
    for k in want:
        assert ckpt._dtype_name(have[k]) == str(want[k].dtype), k
        assert have[k].shape == tuple(want[k].shape), k
        assert _bits(have[k]) == _bits(want[k]), k
    # in place into live tensors, through the manager of the other package
    JCheckpointManager(str(tmp_path / "root")).save(4, tree)
    live = _torch_tree({k: (np.zeros_like(v) if not isinstance(v, dict) else
                            {kk: np.zeros_like(vv) for kk, vv in v.items()})
                        for k, v in a.items()})
    ptrs = {k: t.data_ptr() for k, t in ckpt._flat_items(live)}
    load_state(latest_checkpoint(str(tmp_path / "root")), live)
    for k, t in ckpt._flat_items(live):
        assert t.data_ptr() == ptrs[k]
        assert _bits(t) == _bits(dict(ckpt._flat_items(tree))[k]), k
    bad = _torch_tree(a)
    bad["w"] = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="'w'"):
        load_state(path, bad)


# -- resume of the training step --------------------------------------------------

def _opt():
    return AdamW(lr.LinearWarmup(lr.CosineAnnealingDecay(1e-3, T_max=8), 2,
                                 0.0, 1e-3),
                 grad_clip=ClipGradByGlobalNorm(1.0))


def _steps(step, ids, labels, n):
    """``n`` steps under the schedule: (losses, LR tensor readings)."""
    losses, rates = [], []
    sched = step.optimizer._learning_rate_scheduler
    for _ in range(n):
        losses.append(step(ids, labels).item())
        rates.append(step.optimizer.lr_tensor.item())
        if sched is not None:
            sched.step()
    return losses, rates


def _all_state(step):
    out = {f"param {n}": p for n, p in step.params.items()}
    out.update({f"master {n}": t for n, t in step.state["master"].items()})
    for slot, d in step.state["slots"].items():
        out.update({f"{slot} {n}": t for n, t in d.items()})
    out["step"] = step.state["step"]
    out["rng"] = step.generator.get_state()
    return {k: v.detach().clone() for k, v in out.items()}


def test_resume_gives_the_uninterrupted_bits(tmp_path):
    """2N uninterrupted steps against N, an async save, a fresh step
    from another seed restored, N more; then the first step restored and
    N more: losses, LR readings and every tensor the same bits."""
    cfg = gpt_tiny()
    assert cfg.hidden_dropout_prob == 0.1
    ids, labels = make_batch(cfg, 2, 64, device="cpu")

    def make(seed):
        return build_train_step(cfg, device="cpu", seed=seed, amp_o2=False,
                                optimizer=_opt())
    full = make(0)
    want_loss, want_lr = _steps(full, ids, labels, 6)
    want = _all_state(full)
    half = make(0)
    _steps(half, ids, labels, 3)
    mgr = CheckpointManager(str(tmp_path / "run"), async_save=True)
    save_checkpoint(mgr, 3, half, data_state={"epoch": 0})
    mgr.wait()
    assert mgr.load_data_state()["epoch"] == 0
    fresh = make(1)
    assert restore_checkpoint(mgr, fresh) == 3
    got_loss, got_lr = _steps(fresh, ids, labels, 3)
    assert (got_loss, got_lr) == (want_loss[3:], want_lr[3:])
    got = _all_state(fresh)
    assert [k for k in want if not torch.equal(want[k], got[k])] == []
    ptrs = {n: p.data_ptr() for n, p in full.params.items()}
    lr_ptr = full.optimizer.lr_tensor.data_ptr()
    assert restore_checkpoint(mgr, full) == 3
    assert (ptrs, lr_ptr) == ({n: p.data_ptr()
                               for n, p in full.params.items()},
                              full.optimizer.lr_tensor.data_ptr())
    again = _steps(full, ids, labels, 3)
    assert again == (want_loss[3:], want_lr[3:])
    got = _all_state(full)
    assert [k for k in want if not torch.equal(want[k], got[k])] == []


def test_restore_rebuilds_empty_subtrees_and_checks_the_generator(tmp_path):
    cfg = gpt_tiny(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    ids, labels = make_batch(cfg, 2, 32, device="cpu")
    step = build_train_step(cfg, device="cpu", amp_o2=False,
                            optimizer=SGD(0.1))
    step(ids, labels)
    path = str(tmp_path / "ck")
    save_sharded(step.checkpoint_tree(), path)
    tree = load_sharded(path)                 # no template: no empty dicts
    assert "master" not in tree["opt_tree"] and "slots" not in tree["opt_tree"]
    other = build_train_step(cfg, device="cpu", seed=1, amp_o2=False,
                             optimizer=SGD(0.1))
    other.load_checkpoint_tree(tree)
    assert all(torch.equal(p, other.params[n])
               for n, p in step.params.items())
    assert int(other.state["step"]) == 1
    del tree["params"][next(iter(tree["params"]))]
    with pytest.raises(KeyError):
        other.load_checkpoint_tree(tree)
    cuda_state = torch.zeros(16, dtype=torch.uint8)   # a CUDA generator's
    with pytest.raises(ValueError, match=r"of 16 bytes into a cpu generator"
                                         r".*\(cuda, not cpu\)"):
        restore_generator_state(step.generator, cuda_state)


def _jax_steps(jm, params, state, ids, labels, n):
    loss_of = jm.loss_fn(ids, labels)

    @jax.jit
    def one(params, state):
        (loss, _), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
        new_p, new_s = jm.opt.apply_gradients_tree(params, grads, state)
        return loss, new_p, new_s

    losses = []
    for _ in range(n):
        loss, params, state = one(params, state)
        losses.append(float(loss))
    return losses, params, state


def _port_step(arrays):
    return TrainStep(_port(arrays), GPTPretrainingCriterion(),
                     AdamW(learning_rate=LR, multi_precision=True),
                     make_generator(0, "cpu"), fusion=False)


@pytest.fixture(scope="module", autouse=True)
def _collect_at_end():
    """Free the JAX arrays this module's fixtures held (their objects
    sit in reference cycles) before the next module in the process."""
    yield
    gc.collect()


@pytest.fixture(scope="module")
def jax_model():
    return _Jax()


def test_jax_checkpoint_resumes_in_the_port(tmp_path, jax_model):
    jm = jax_model
    ids, labels = _batch()
    params = jm.params
    _, params, state = _jax_steps(jm, params, jm.opt.init_state_tree(params),
                                  ids, labels, 2)
    JCheckpointManager(str(tmp_path / "run")).save(
        2, {"params": params, "opt_tree": state})
    jlosses, jparams, _ = _jax_steps(jm, params, state, ids, labels, 2)
    step = _port_step(jm.f32)
    assert restore_checkpoint(CheckpointManager(str(tmp_path / "run")),
                              step) == 2
    assert int(step.state["step"]) == 2 and step.state["master"] == {}
    losses = [step(_t(ids), _t(labels)).item() for _ in range(2)]
    np.testing.assert_allclose(losses, jlosses, atol=1e-5)
    for name, p in step.params.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jparams[name]), rtol=0,
                                   atol=2 * LR, err_msg=name)


def test_port_checkpoint_resumes_in_jax(tmp_path, jax_model):
    jm = jax_model
    ids, labels = _batch()
    step = _port_step(jm.f32)
    for _ in range(2):
        step(_t(ids), _t(labels))
    save_checkpoint(CheckpointManager(str(tmp_path / "run")), 2, step)
    losses = [step(_t(ids), _t(labels)).item() for _ in range(2)]
    template = {"params": jm.params,
                "opt_tree": jm.opt.init_state_tree(jm.params)}
    tree, n = JCheckpointManager(str(tmp_path / "run")).restore_latest(
        template=template)
    assert n == 2 and int(tree["opt_tree"]["step"]) == 2
    assert "rng" not in tree                  # a JAX template ignores it
    jlosses, jparams, _ = _jax_steps(jm, tree["params"], tree["opt_tree"],
                                     ids, labels, 2)
    np.testing.assert_allclose(jlosses, losses, atol=1e-5)
    for name, p in step.params.items():
        np.testing.assert_allclose(np.asarray(jparams[name]),
                                   p.detach().numpy(), rtol=0, atol=2 * LR,
                                   err_msg=name)


def test_schedule_state_rides_data_state_into_the_jax_scheduler(tmp_path):
    cfg = gpt_tiny()
    ids, labels = make_batch(cfg, 2, 32, device="cpu")
    step = build_train_step(cfg, device="cpu", amp_o2=False,
                            optimizer=_opt())
    _steps(step, ids, labels, 3)
    mgr = CheckpointManager(str(tmp_path / "run"))
    save_checkpoint(mgr, 3, step)
    saved = mgr.load_data_state(3)["LR_Scheduler"]
    jsched = pt.optimizer.lr.LinearWarmup(
        pt.optimizer.lr.CosineAnnealingDecay(1e-3, T_max=8), 2, 0.0, 1e-3)
    jsched.set_state_dict(saved)
    sched = step.optimizer._learning_rate_scheduler
    rates, jrates = [], []
    for _ in range(6):
        rates.append(sched())
        jrates.append(jsched())
        sched.step()
        jsched.step()
    assert rates == jrates and len(set(rates)) > 1
