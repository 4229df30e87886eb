"""The port's telemetry hooks on the training paths against the JAX
package's, on the CPU: the captured step's cache hits and misses (with
their reasons) and its compiles, hapi's and ``Engine.fit``'s steps and
the DataLoader's waits, the checkpoint manager's saves, restores and
retention, and the fusion pass's rewrites.

On the CPU the port's ``capture_step`` runs eagerly and books nothing;
its cache logic is driven here with a stand-in for the CUDA graph (the
graph itself is ``chip_smoke.py``'s to check on the card).
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.observability as jobs
from paddle_tpu.distributed.checkpoint_manager import \
    CheckpointManager as JManager
import paddle_tpu_torch.observability as tobs
from paddle_tpu_torch import hapi, io as tio, nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import CheckpointManager
from paddle_tpu_torch.framework.random import make_generator
from paddle_tpu_torch.jit import capture as tcapture
from paddle_tpu_torch.nn.initializer import XavierNormal


@pytest.fixture(autouse=True)
def telemetry_on():
    jobs.reset()
    tobs.reset()
    jobs.get_telemetry().enable(compile_watch=False)
    tobs.configure(enabled=True)
    yield
    jobs.reset()
    tobs.reset()


def _series(mod, name):
    m = mod.get_registry().snapshot().get(name)
    if m is None:
        return {}
    return {k: (v["count"] if m["kind"] == "histogram" else v)
            for k, v in m["series"].items()}


# -- the captured step ------------------------------------------------------------------

class _FakeGraph:
    """What ``CapturedGraph.capture`` returns, without CUDA: a replay
    runs the step on the static inputs."""

    def __init__(self, fn, args, kwargs):
        self.fn, self.args, self.kwargs = fn, args, kwargs
        self.inputs = [t for t in tcapture._leaves((args, kwargs))
                       if isinstance(t, torch.Tensor)]
        self.capture_s = 0.0
        self.out = None

    def replay(self):
        self.out = self.fn(*self.args, **self.kwargs)

    def cloned_outputs(self):
        return self.out.clone()


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setattr(tcapture, "_device_of",
                        lambda leaves, modules: torch.device("cuda"))
    monkeypatch.setattr(tcapture, "capture_stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(tcapture.CapturedGraph, "warm_up",
                        staticmethod(lambda fn, a, kw, stream: fn(*a, **kw)))
    monkeypatch.setattr(
        tcapture.CapturedGraph, "capture",
        classmethod(lambda cls, fn, a, kw, **_: _FakeGraph(fn, a, kw)))


def _capture_run(mod, f, make):
    """3 calls at one shape, 2 at another, 1 back at the first."""
    step = mod(f)
    for shape in ((4, 4),) * 3 + ((2, 4),) * 2 + ((4, 4),):
        step(make(shape), make(shape))
    return step


def test_capture_hits_misses_and_compiles_match_jax(fake_card):
    def jf(a, b):
        return a * b + b

    def tf(a, b):
        return a * b + b

    js = _capture_run(pt.jit.capture_step, jf,
                      lambda s: pt.to_tensor(np.ones(s, np.float32)))
    ts = _capture_run(tcapture.capture_step, tf,
                      lambda s: torch.ones(s))
    jstats = {k: js.stats[k] for k in ("hits", "misses", "compiles")}
    assert {k: ts.stats[k] for k in jstats} == jstats == {
        "hits": 4, "misses": 2, "compiles": 2}
    jsnap = jobs.get_telemetry().snapshot()["capture"]
    assert tobs.get_telemetry().snapshot()["capture"] == jsnap == {
        "hits": 4, "misses": {"first_trace": 1, "signature_change": 1}}
    for name in ("pt_capture_cache_hits_total",
                 "pt_capture_cache_misses_total"):
        assert _series(tobs, name) == _series(jobs, name)
    # each recorded graph is a compile of the captured step
    assert tobs.get_telemetry().sentinel.compile_counts() == {
        "captured_step(tf)": 2}
    assert _series(tobs, "pt_compiles_total") == {
        "fn=captured_step(tf)": 2.0}


def test_capture_fallback_books_its_reason(fake_card, monkeypatch):
    def boom(cls, fn, a, kw, **_):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
    monkeypatch.setattr(tcapture.CapturedGraph, "capture",
                        classmethod(boom))
    step = tcapture.capture_step(lambda a: a + 1)
    step(torch.ones(2))
    step(torch.ones(2))
    assert step.stats["fallback"] == "capture_unsafe"
    assert tobs.get_telemetry().snapshot()["capture"] == {
        "hits": 0, "misses": {"first_trace": 1, "capture_unsafe": 1}}


def test_the_cpu_path_books_no_capture():
    step = tcapture.capture_step(lambda a: a + 1)
    step(torch.ones(2))
    assert step.stats["fallback"] == "cpu"
    assert tobs.get_telemetry().snapshot()["capture"] == {"hits": 0,
                                                          "misses": {}}


# -- hapi and the DataLoader -------------------------------------------------------------

class _Shapes:
    def __init__(self, n=24):
        rng = np.random.RandomState(0)
        self.x = rng.randn(n, 3, 4, 4).astype(np.float32)
        self.y = (np.arange(n) % 4).astype(np.int64)

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.y)


class _JData(_Shapes, pt.io.Dataset):
    pass


class _TData(_Shapes, tio.Dataset):
    pass


@pytest.mark.parametrize("workers", [0, 2])
def test_hapi_fit_books_a_step_and_a_wait_each_batch(workers):
    pt.seed(0)
    jnet = pt.nn.Sequential(pt.nn.Flatten(), pt.nn.Linear(48, 4))
    jm = pt.Model(jnet)
    jm.prepare(optimizer=pt.optimizer.Adam(learning_rate=0.01,
                                           parameters=jnet.parameters()),
               loss=pt.nn.CrossEntropyLoss())
    jm.fit(pt.io.DataLoader(_JData(), batch_size=4), epochs=2, verbose=0)
    jm.evaluate(_JData(), batch_size=8, verbose=0)
    tnet = torch.nn.Sequential(torch.nn.Flatten(), tnn.Linear(
        48, 4, XavierNormal(), generator=make_generator(0, "cpu")))
    tm = hapi.Model(tnet)
    tm.prepare(optimizer=topt.Adam(learning_rate=0.01,
                                   parameters=tnet.parameters()),
               loss=tnn.CrossEntropyLoss())
    tm.fit(tio.DataLoader(_TData(), batch_size=4, num_workers=workers),
           epochs=2, verbose=0)
    tm.evaluate(_TData(), batch_size=8, verbose=0)
    # 2 epochs of 6 batches, then 3 eval batches
    for name in ("pt_steps_total", "pt_step_time_seconds"):
        assert _series(tobs, name) == _series(jobs, name) == {
            "mode=train": 12, "mode=eval": 3}
    assert _series(tobs, "pt_data_wait_seconds") == \
        _series(jobs, "pt_data_wait_seconds") == {"": 15}
    assert _series(tobs, "pt_data_batches_total") == {"": 15.0}
    assert _series(tobs, "pt_throughput_samples_per_second").keys() == {
        "mode=train", "mode=eval"}
    snap = tobs.get_telemetry().snapshot()
    assert snap["steps"] == 15 and snap["step_ms_p50"] > 0


def test_engine_fit_books_its_steps():
    from paddle_tpu_torch.distributed import Engine
    tnet = torch.nn.Sequential(torch.nn.Flatten(), tnn.Linear(
        48, 4, XavierNormal(), generator=make_generator(0, "cpu")))
    eng = Engine(tnet, loss=tnn.CrossEntropyLoss(),
                 optimizer=topt.Adam(learning_rate=0.01,
                                     parameters=tnet.parameters()))
    eng.fit(_TData(), batch_size=4, epochs=1, verbose=0)
    assert _series(tobs, "pt_steps_total") == {"mode=train": 6.0}
    assert _series(tobs, "pt_data_wait_seconds") == {"": 6}


# -- checkpoints -------------------------------------------------------------------------

def test_checkpoint_manager_books_like_jax(tmp_path):
    import jax.numpy as jnp
    for mod, mgr, make in (
            (jobs, JManager(str(tmp_path / "jax"), keep_last_n=1),
             lambda v: {"w": jnp.full((3,), v, jnp.float32)}),
            (tobs, CheckpointManager(str(tmp_path / "port"), keep_last_n=1),
             lambda v: {"w": torch.full((3,), v)})):
        for step in (1, 2, 3):
            mgr.save(step, make(float(step)))
        state, step = mgr.restore_latest()
        assert step == 3 and float(state["w"][0]) == 3.0
    for name in ("pt_checkpoint_ops_total", "pt_checkpoint_save_seconds",
                 "pt_checkpoint_restore_seconds",
                 "pt_checkpoint_latest_step",
                 "pt_checkpoint_gc_deleted_total"):
        assert _series(tobs, name) == _series(jobs, name), name
    assert _series(tobs, "pt_checkpoint_ops_total") == {
        "op=save,status=ok": 3.0, "op=restore,status=ok": 1.0}
    assert _series(tobs, "pt_checkpoint_gc_deleted_total") == {"": 2.0}
    assert tobs.get_telemetry().snapshot()["last_checkpoint_step"] == 3


def test_checkpoint_failures_are_booked(tmp_path, monkeypatch):
    from paddle_tpu_torch.distributed import checkpoint as tckpt
    mgr = CheckpointManager(str(tmp_path / "a"), keep_last_n=None)
    mgr.save(1, {"w": torch.ones(2)})
    real = tckpt._save_records

    def broken(*a, **kw):
        raise OSError("disk full")
    monkeypatch.setattr(tckpt, "_save_records", broken)
    with pytest.raises(OSError):
        mgr.save(2, {"w": torch.ones(2)})
    amgr = CheckpointManager(str(tmp_path / "b"), async_save=True)
    amgr.save(1, {"w": torch.ones(2)})
    with pytest.raises(OSError):
        amgr.wait()
    monkeypatch.setattr(tckpt, "_save_records", real)
    # a corrupt newest step: the restore falls back, booking both tries
    mgr.save(3, {"w": torch.ones(2)})
    for where, _, files in os.walk(os.path.join(mgr.step_dir(3), "data")):
        for name in files:
            with open(os.path.join(where, name), "r+b") as f:
                f.write(b"\xff\xff\xff\xff")
    _, step = mgr.restore_latest()
    assert step == 1
    assert _series(tobs, "pt_checkpoint_ops_total") == {
        "op=save,status=ok": 2.0, "op=save,status=sync_error": 1.0,
        "op=save,status=async_error": 1.0,
        "op=restore,status=error": 1.0, "op=restore,status=ok": 1.0}


def test_staging_sweep_is_booked(tmp_path):
    import time
    from paddle_tpu_torch.distributed.checkpoint import sweep_staging
    root = tmp_path / "ck"
    for n in ("step_00000001.tmp.aa", "step_00000002.tmp.bb"):
        os.makedirs(root / n)
    old = time.time() - 7200
    os.utime(root / "step_00000001.tmp.aa", (old, old))
    assert sweep_staging(str(root), max_age=3600.0) == 1
    assert _series(tobs, "pt_checkpoint_staging_orphans_swept_total") == {
        "": 1.0}


# -- the fusion pass ---------------------------------------------------------------------

def test_fusion_rewrites_are_booked():
    from paddle_tpu_torch.incubate.models import gpt_tiny
    from paddle_tpu_torch.ops import fusion_pass as fp
    from paddle_tpu_torch.train import build_train_step, make_batch
    cfg = gpt_tiny()
    before = fp.summary()["rewrites"]
    step = build_train_step(cfg, device="cpu", amp_o2=False, fusion=True)
    ids, labels = make_batch(cfg, 2, 32, device="cpu")
    step(ids, labels)
    after = fp.summary()["rewrites"]
    new = {k: after[k] - before.get(k, 0) for k in after
           if after[k] != before.get(k, 0)}
    assert new and tobs.get_telemetry().snapshot()["fusion"] == {
        "rewrites": new, "fallbacks": {}}
    assert _series(tobs, "pt_fusion_rewrites_total") == {
        f"pattern={k}": float(v) for k, v in new.items()}
